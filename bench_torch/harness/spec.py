"""What ``BENCHMARK.json`` names, found by name under ``bench_torch/``.

Everything that belongs to one configuration, traffic mix, per-layer
metric or kernel sits in files of its own, found here by the name that
``BENCHMARK.json`` gives it:

* ``configs/<config>.json``   the configuration as it is run;
* ``configs/<config>.py``     its plain reference (``render``);
* ``presets/<preset>.py``     the preset writer the configuration names;
* ``traffic/<mix>.json``      the traffic mix's parameters;
* ``metrics/<metric>.py``     a per-layer metric's reader (``read``);
* ``work/<kernel>.py``        a kernel's operations and bytes (``work``).

A new configuration, mix, metric or kernel is new files plus new entries
in ``BENCHMARK.json``: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

_MODULES: dict = {}


def load_module(path: Path):
    """Import the Python file ``path`` (its name may hold ``-`` and ``.``)."""
    path = Path(path).resolve()
    mod = _MODULES.get(path)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"benchmark: no file {path}")
        name = "bench_" + re.sub(r"\W", "_", str(path.with_suffix("")))
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod


def load_benchmark(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files resolved."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    bench: Path = BENCH

    @property
    def batch(self) -> int:
        """Frames an apply: the configuration's batch, 1 where the mix
        sends frames one at a time."""
        return int(self.traffic.get("batch") or self.config["batch"])

    @property
    def src_hw(self) -> tuple:
        return tuple(self.config["source_hw"])

    @property
    def viewport(self) -> tuple:
        """(W, H) of the output."""
        return tuple(self.config["viewport"])

    def reference(self):
        return load_module(self.bench / "configs" / f"{self.config['name']}.py")

    def preset_writer(self):
        return load_module(self.bench / "presets" / f"{self.config['preset']}.py")

    def reader(self, metric: str):
        return load_module(self.bench / "metrics" / f"{metric}.py")

    def work(self, kernel: str):
        return load_module(self.bench / "work" / f"{kernel}.py")


def resolve(name: str, bench: dict | None = None, root: Path = ROOT, config: dict | None = None,
            traffic: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and metrics. ``config`` and ``traffic`` replace keys of the
    configuration and the mix (the CPU rehearsal and the tests run the
    cells at a tiny size)."""
    bench = bench if bench is not None else load_benchmark(root)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"benchmark: no workload {name!r} in BENCHMARK.json")
    wl = found[0]
    bdir = Path(root) / "bench_torch"
    configs = {c["name"]: c for c in bench["configs"]}
    with open(Path(root) / configs[wl["config"]]["file"]) as f:
        conf = json.load(f)
    conf.update(config or {})
    with open(bdir / "traffic" / f"{wl['traffic']}.json") as f:
        mix = json.load(f)
    mix.update(traffic or {})
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    layer = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(name, wl, conf, mix, e2e, layer, bdir)
