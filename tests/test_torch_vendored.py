"""The port's copies of the JAX package's jax-free modules stay identical
to their originals, and the port never imports jax or retrocapture_tpu.

``retrocapture_tpu/__init__.py`` imports jax, so even its jax-free
modules cannot be imported from the port on a machine without jax: they
are copied. Each copy may differ from its original only in the package
name on its import lines, and in the one place where the original names
the directory its shader corpus is mounted at (``utils/scanner.py``; the
port looks for ``shaders_glsl`` in the working directory).
"""

import ast
import pathlib
import re
import subprocess
import sys

import numpy as np

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
COPIED = [
    "presets/__init__.py",
    "presets/glslp.py",
    "frontend/__init__.py",
    "frontend/cpp.py",
    "frontend/glsl_ast.py",
    "frontend/glsl_parser.py",
    "graph/scale.py",
    "utils/logging.py",
    "utils/paths.py",
    "utils/metrics.py",
    "utils/scanner.py",
    "io/__init__.py",
    "io/testpattern.py",
    "io/native.py",
    "runtime/config.py",
]
_CORPUS_DIR = re.compile(r'Path\("[^"]*shaders_glsl"\)')


def _normalised(path: pathlib.Path, pkg: str) -> list[str]:
    out = []
    for line in path.read_text(encoding="utf-8").splitlines():
        stripped = line.lstrip()
        if stripped.startswith(("from ", "import ")):
            line = line.replace(pkg + ".", "PKG.").replace(pkg + " ", "PKG ")
        out.append(_CORPUS_DIR.sub("Path(CORPUS)", line))
    return out


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_original(rel):
    original = _normalised(REPO / "retrocapture_tpu" / rel, "retrocapture_tpu")
    copy = _normalised(REPO / "retrocapture_tpu_torch" / rel, "retrocapture_tpu_torch")
    assert copy == original, f"retrocapture_tpu_torch/{rel} drifted from retrocapture_tpu/{rel}"


# Numpy helpers and constants the port copies into modules of its own
# (their originals sit beside jax code): (reference file, port file,
# top-level names). These carry the plans and constants the kernels run
# on, as weights would in a model.
COPIED_DEFS = [
    (
        "ops/pallas/blur_groups.py",
        "ops/cuda/blur_groups.py",
        ["TX", "TY", "_KB_CAP", "_VMEM_TEX_BYTES", "BlurGroup", "_rank2", "_static_plan", "_static_plan_v2"],
    ),
    ("ops/pallas/resample.py", "ops/cuda/resample.py", ["_xphase_plan"]),
    ("ops/pallas/preconv_blur.py", "ops/preconv_blur.py", ["_PAD", "_AxisPlan", "GroupPlan", "plan_group"]),
    (
        "graph/kernels.py",
        "graph/kernels.py",
        [
            "_MATTIAS_W", "_mattias_max_dudv", "_MATTIAS_GROUPS", "_XBR_RGBW", "_XBR_TAPS",
            "_NTSC_PI", "_NTSC_CMF2", "_NTSC_YIQ_COLS", "_NTSC2_LUMA", "_NTSC2_CHROMA", "_NTSC_YIQ2RGB_COLS",
            "_ntsc_band_np_cols", "_NNEDI3_W_RE", "_nnedi3_weights",
        ],
    ),
    (
        "ops/pallas/xbr_epilogue.py",
        "ops/cuda/xbr_epilogue.py",
        ["_AO", "_BO", "_CO", "_AX", "_BX", "_CX", "_AY", "_BY", "_CY", "_D4", "_DL", "_DU"],
    ),
    ("io/queue.py", "io/queue.py", ["FrameQueue"]),
    ("ops/sampling.py", "ops/sampling.py", ["_wrap_index_np", "_axis_matrix", "_separable_rows", "_axis_stride"]),
    ("runtime/engine.py", "runtime/engine.py", ["_grids", "_npz_path", "MAX_FRAME_HISTORY"]),
    ("runtime/pipeline.py", "runtime/pipeline.py", ["ImageSettings"]),
]


def _top_level(path: pathlib.Path, names) -> dict[str, str]:
    src = path.read_text(encoding="utf-8")
    out = {}
    for node in ast.parse(src).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            name = node.name
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
        else:
            continue
        if name in names:
            out[name] = ast.get_source_segment(src, node)
    return out


@pytest.mark.parametrize("ref,port,names", COPIED_DEFS, ids=[c[1] for c in COPIED_DEFS])
def test_copied_helpers_match_original(ref, port, names):
    original = _top_level(REPO / "retrocapture_tpu" / ref, names)
    copy = _top_level(REPO / "retrocapture_tpu_torch" / port, names)
    assert sorted(original) == sorted(copy) == sorted(names)
    for name in names:
        assert copy[name] == original[name], f"retrocapture_tpu_torch/{port}: {name} drifted from retrocapture_tpu/{ref}"


def test_copied_constants_and_plans_equal_the_reference():
    """The same values at run time: the mattias constants, and the plans
    the copied helpers build for the slice's geometry."""
    from retrocapture_tpu.graph import kernels as jk
    from retrocapture_tpu.ops.pallas import blur_groups as jbg
    from retrocapture_tpu.ops.pallas import preconv_blur as jpc
    from retrocapture_tpu.ops.pallas import resample as jrs
    from retrocapture_tpu.ops.sampling import _axis_matrix

    from retrocapture_tpu_torch.graph import kernels as tk
    from retrocapture_tpu_torch.ops import preconv_blur as pc
    from retrocapture_tpu_torch.ops.cuda import blur_groups as bg
    from retrocapture_tpu_torch.ops.cuda import resample as rs

    assert np.array_equal(tk._MATTIAS_W, jk._MATTIAS_W) and tk._MATTIAS_W.dtype == jk._MATTIAS_W.dtype
    assert tk._MATTIAS_GROUPS == jk._MATTIAS_GROUPS
    assert tk._MATTIAS_MAX_DUDV == jk._MATTIAS_MAX_DUDV
    groups = tk.mattias_groups(1920, 1080)
    jgroups = [jbg.BlurGroup(g.channel, g.bx, g.by, g.xo, g.yo, g.weights, g.scale) for g in groups]
    for g, w in zip(groups, bg.weight_tables(groups, "v1")):
        (a0, b0), (a1, b1) = bg._rank2(g.weights * g.scale)[0]
        (c0, d0), (c1, d1) = jbg._rank2(g.weights * g.scale)[0]
        for x, y in ((a0, c0), (b0, d0), (a1, c1), (b1, d1)):
            assert np.array_equal(x, y)
    p = bg._static_plan_v2(groups, 320, 240, 1080, 1920, tk._MATTIAS_MAX_DUDV)
    q = jbg._static_plan_v2(jgroups, 320, 240, 1080, 1920, jk._MATTIAS_MAX_DUDV)
    assert len(p) == len(q) == 9
    for a, b in zip(p, q):
        assert np.array_equal(a["w32"], b["w32"]) and (a["xi"], a["yj"], a["taus"], a["R"]) == (b["xi"], b["yj"], b["taus"], b["R"])
    for g, jg in zip(groups, jgroups):
        a, b = pc.plan_group(g, 320, 240), jpc.plan_group(jg, 320, 240)
        assert np.array_equal(a.table, b.table) and np.array_equal(a.droffs, b.droffs) and np.array_equal(a.dsoffs, b.dsoffs)
    coord = ((np.arange(1920, dtype=np.float64) + 0.5) / 1920.0).astype(np.float32)
    ax = _axis_matrix(coord, 320, True, "clamp_to_edge")
    (r, d, w0, w1), (jr, jd, jw0, jw1) = rs._xphase_plan(ax, 320, 1920), jrs._xphase_plan(ax, 320, 1920)
    assert (r, d) == (jr, jd) and np.array_equal(w0, jw0) and np.array_equal(w1, jw1)


_PROBE = r"""
import importlib, pkgutil, sys
import retrocapture_tpu_torch
for m in pkgutil.walk_packages(retrocapture_tpu_torch.__path__, "retrocapture_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(
    n for n in sys.modules
    if n == "jax" or n.startswith(("jax.", "jaxlib")) or n == "retrocapture_tpu" or n.startswith("retrocapture_tpu.")
)
print("BAD:" + ",".join(bad))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("BAD:")][-1]
    assert line == "BAD:", f"imported: {line[4:]}"


def test_no_source_line_imports_jax():
    for path in sorted((REPO / "retrocapture_tpu_torch").rglob("*.py")):
        for n, line in enumerate(path.read_text(encoding="utf-8").splitlines(), 1):
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import retrocapture_tpu.", "from retrocapture_tpu.")), (
                f"{path.relative_to(REPO)}:{n}: {s}"
            )
            assert not (s.startswith("import retrocapture_tpu") and not s.startswith("import retrocapture_tpu_torch")), (
                f"{path.relative_to(REPO)}:{n}: {s}"
            )
    for path in ("tools/torch_kernel_table.py", "tests/test_torch_cuda.py", "tests/_card.py", "tests/_presets.py"):
        assert not (REPO / path).read_text().count("import jax"), path


def test_cli_keeps_the_reference_flags():
    """The port's command line takes every flag of the reference's, with
    the same defaults (but the shader root, which names no mount)."""
    from retrocapture_tpu import cli as jcli
    from retrocapture_tpu_torch import cli as tcli

    def flags(parser):
        return {
            a.option_strings[0]: (a.default, a.choices, a.type, type(a).__name__)
            for a in parser._actions
            if a.option_strings and a.option_strings[0] != "--shader-root"
        }

    assert flags(tcli.build_parser()) == flags(jcli.build_parser())


def test_native_copy_points_at_the_repo_root():
    from retrocapture_tpu.io import native as jn
    from retrocapture_tpu_torch.io import native as tn

    assert tn._ROOT == jn._ROOT == REPO and tn._SO == jn._SO
