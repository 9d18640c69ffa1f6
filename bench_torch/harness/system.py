"""The system under test: the port's ``Engine`` for one configuration.

This is the only module of the benchmark that imports the program
(``retrocapture_tpu_torch``, never the JAX package). The preset is
written by the configuration's preset writer into a fixed directory of
the checkout (``build/bench_presets/<config>``), so that no run writes
outside it.
"""

from __future__ import annotations

import sys

from harness.spec import ROOT, Cell

PRESET_DIR = ROOT / "build" / "bench_presets"


def program():
    """The port's package, imported from the checkout this file is in."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import retrocapture_tpu_torch

    return retrocapture_tpu_torch


def engine(cell: Cell, device: str):
    """An Engine on ``device`` with the configuration's preset, viewport,
    parameter mode and parameters."""
    pkg = program()
    out = PRESET_DIR / cell.config["name"]
    out.mkdir(parents=True, exist_ok=True)
    path = cell.preset_writer().write(str(out))
    e = pkg.Engine(viewport=tuple(cell.viewport), device=device)
    if not e.load_preset(path):
        raise RuntimeError(f"{cell.config['name']}: the preset did not load: {e.last_error}")
    e.set_param_mode(cell.config["param_mode"])
    for name, value in cell.config["parameters"].items():
        if not e.set_parameter(name, value):
            raise RuntimeError(f"{cell.config['name']}: the preset has no parameter {name}")
    return e


def stream(source, process, batch: int, device: str):
    """The program's frame queue (``io.queue.stream``)."""
    program()
    from retrocapture_tpu_torch.io.queue import stream as queue_stream

    return queue_stream(source, process, batch=batch, device=device)
