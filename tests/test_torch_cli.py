"""``python -m retrocapture_tpu_torch`` (cli.py) against the JAX package's
CLI, both in process on the CPU (``--cpu``), and utils/thumbnails.py.

Tolerance: the .npy outputs are f32 frames through feedback-ghost and a
LINEAR blit; within 1e-6, and within 1/255 + 1e-6 in at most 0.1% of values
where an RGBA8 store flipped one code (the gate of
tests/test_torch_engine.py; measured: bit-equal).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from retrocapture_tpu import cli as jcli
from retrocapture_tpu_torch import cli as tcli
from test_torch_engine import _close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEEDBACK = os.path.join(REPO, "assets", "presets", "feedback-ghost.glslp")
COMMON = ["--source", "test", "--preset", FEEDBACK, "--width", "64", "--height", "48", "--viewport", "160x120",
          "--frames", "6", "--batch", "4", "--stats"]


def _stats(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_matches_reference_cli(tmp_path, capsys):
    assert jcli.main(COMMON + ["--cpu", "--output", str(tmp_path / "jax")]) == 0
    js = _stats(capsys)
    assert tcli.main(COMMON + ["--cpu", "--output", str(tmp_path / "torch")]) == 0
    ts = _stats(capsys)
    a, b = np.load(tmp_path / "jax.npy"), np.load(tmp_path / "torch.npy")
    assert b.shape == (6, 120, 160, 3) and b.dtype == np.float32
    _close(a, b, "f32")
    assert ts["frames"] == js["frames"] == 6 and ts["shader_active"] is True and js["shader_active"] is True
    assert ts["output_shape"] == js["output_shape"] == [6, 120, 160, 3]
    assert abs(ts["mean"] - js["mean"]) <= 1e-6 and abs(ts["std"] - js["std"]) <= 1e-6
    assert not (tmp_path / "torch.png").exists()  # several frames write only the .npy


def test_cli_pipeline_flags_match_reference_cli(tmp_path, capsys):
    flags = ["--logical-width", "32", "--logical-height", "24", "--overscan-x", "2", "--overscan-y", "2",
             "--brightness", "1.1", "--contrast", "0.9", "--flip-y", "--param", "GHOST=0.6",
             "--max-resolution", "48x36", "--save-state", str(tmp_path / "st")]
    assert jcli.main(COMMON + flags + ["--cpu", "--output", str(tmp_path / "jax")]) == 0
    assert tcli.main(COMMON + flags + ["--cpu", "--output", str(tmp_path / "torch")]) == 0
    capsys.readouterr()
    _close(np.load(tmp_path / "jax.npy"), np.load(tmp_path / "torch.npy"), "f32")
    assert (tmp_path / "st.npz").is_file()
    # The saved state continues a second run.
    assert tcli.main(COMMON + ["--cpu", "--load-state", str(tmp_path / "st"), "--output", str(tmp_path / "t2")]) == 0
    assert np.load(tmp_path / "t2.npy").shape == (6, 120, 160, 3)


def test_cli_list_parameters_and_sources(tmp_path, capsys):
    assert tcli.main(["--cpu", "--preset", FEEDBACK, "--list-parameters"]) == 0
    params = json.loads(capsys.readouterr().out)
    assert [p["name"] for p in params] == ["GHOST"]
    frames = np.random.default_rng(0).integers(0, 256, (3, 48, 64, 3), dtype=np.uint8)
    np.save(tmp_path / "in.npy", frames)
    assert tcli.main(["--cpu", "--source", "npy", "--input", str(tmp_path / "in.npy"), "--stats"]) == 0
    assert _stats(capsys)["output_shape"] == [3, 48, 64, 3]  # no preset: passthrough at the source size
    (tmp_path / "root" / "a").mkdir(parents=True)
    (tmp_path / "root" / "a" / "x.glslp").write_text("shaders = 0\n")
    assert tcli.main(["--list-presets", "--shader-root", str(tmp_path / "root")]) == 0
    assert capsys.readouterr().out.split() == ["a/x.glslp"]


def test_cli_param_mode_traced_matches_reference_cli(tmp_path, capsys):
    """--param-mode traced with a --param override runs in both CLIs and
    gives the same frames (feedback-ghost is bit-equal in traced mode)."""
    extra = ["--cpu", "--param-mode", "traced", "--param", "GHOST=0.8"]
    assert jcli.main(COMMON + extra + ["--output", str(tmp_path / "jax")]) == 0
    js = _stats(capsys)
    assert tcli.main(COMMON + extra + ["--output", str(tmp_path / "torch")]) == 0
    ts = _stats(capsys)
    a, b = np.load(tmp_path / "jax.npy"), np.load(tmp_path / "torch.npy")
    assert b.shape == (6, 120, 160, 3)
    np.testing.assert_array_equal(b, a)
    assert ts["frames"] == js["frames"] == 6
    assert tcli.build_parser().prog == "retrocapture_tpu_torch"


def test_cli_runs_on_the_card_unless_asked(monkeypatch):
    """Without --cpu and without a card the CLI stops with the Engine's
    error; it does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(COMMON)


def test_module_entry_point():
    """python -m retrocapture_tpu_torch with a preset path relative to the
    working directory, as the README gives it."""
    cmd = [sys.executable, "-m", "retrocapture_tpu_torch", "--cpu", "--source", "test", "--preset",
           "assets/presets/feedback-ghost.glslp", "--width", "64", "--height", "48", "--viewport", "160x120",
           "--frames", "4", "--stats"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["frames"] == 4 and stats["shader_active"] is True and stats["output_shape"] == [4, 120, 160, 3]
    if not torch.cuda.is_available():
        proc = subprocess.run([c for c in cmd if c != "--cpu"], cwd=REPO, capture_output=True, text=True, timeout=300)
        assert proc.returncode != 0 and "CUDA is not available" in proc.stderr and proc.stdout.strip() == ""


def test_thumbnail_generation(tmp_path):
    pytest.importorskip("PIL")
    from PIL import Image

    from retrocapture_tpu_torch.utils.thumbnails import generate_gallery, generate_preset_thumbnail

    dest = tmp_path / "thumb.png"
    assert generate_preset_thumbnail(FEEDBACK, dest, size=(64, 48), device="cpu") and dest.is_file()
    with Image.open(dest) as im:
        assert im.size == (64, 48)
    # failing preset -> no thumbnail
    assert not generate_preset_thumbnail(tmp_path / "nonexistent.glslp", tmp_path / "x.png", device="cpu")
    res = generate_gallery(os.path.dirname(FEEDBACK), tmp_path / "gallery", size=(32, 24), device="cpu")
    assert res == {"feedback-ghost.glslp": True} and (tmp_path / "gallery" / "feedback-ghost.png").is_file()


def test_gallery_raises_a_device_or_kernel_failure(tmp_path, monkeypatch):
    """generate_gallery keeps going past a preset that fails (False), but a
    RuntimeError (no device, a kernel that did not build or launch) is
    raised, not turned into False."""
    from retrocapture_tpu_torch.utils import thumbnails

    def fail(error):
        def thumb(*a, **k):
            raise error
        return thumb

    root = os.path.dirname(FEEDBACK)
    monkeypatch.setattr(thumbnails, "generate_preset_thumbnail", fail(OSError("disk full")))
    assert thumbnails.generate_gallery(root, tmp_path / "g", device="cpu") == {"feedback-ghost.glslp": False}
    monkeypatch.setattr(thumbnails, "generate_preset_thumbnail", fail(RuntimeError("nvcc failed: warp_sample.cu")))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        thumbnails.generate_gallery(root, tmp_path / "g", device="cpu")
