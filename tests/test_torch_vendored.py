"""The port's copies of the JAX package's jax-free modules stay identical
to their originals, and the port never imports jax or retrocapture_tpu.

``retrocapture_tpu/__init__.py`` imports jax, so even its jax-free
modules cannot be imported from the port on a machine without jax: they
are copied. Each copy may differ from its original only in the package
name on its import lines.
"""

import pathlib
import subprocess
import sys

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
]


def _normalised(path: pathlib.Path, pkg: str) -> list[str]:
    out = []
    for line in path.read_text(encoding="utf-8").splitlines():
        stripped = line.lstrip()
        if stripped.startswith(("from ", "import ")):
            line = line.replace(pkg + ".", "PKG.").replace(pkg + " ", "PKG ")
        out.append(line)
    return out


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_original(rel):
    original = _normalised(REPO / "retrocapture_tpu" / rel, "retrocapture_tpu")
    copy = _normalised(REPO / "retrocapture_tpu_torch" / rel, "retrocapture_tpu_torch")
    assert copy == original, f"retrocapture_tpu_torch/{rel} drifted from retrocapture_tpu/{rel}"


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
    assert not (REPO / "chip_smoke.py").read_text().count("import jax")
