"""BENCHMARK.json against the benchmark's contract, and its files found by name."""

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import spec  # noqa: E402

ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench_torch"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_workload_resolves_its_files(workload):
    cell = spec.resolve(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert callable(cell.reference().render)
    assert callable(cell.preset_writer().write)
    assert cell.traffic["loop"] in ("closed", "open")
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.reader(m["name"]).read), m["name"]


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            yield entry["name"]
    for w in SPEC["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in SPEC["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    for w in metric.get("workloads", []):
        assert w in WORKLOADS
    if metric in SPEC["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in metric["layer"] and 1 <= len(metric["layer"]) <= 200


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_reports_what_its_per_layer_metrics_move(workload):
    cell = spec.resolve(workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], m["moves"])


def test_distinct_names_and_files():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200


def test_a_new_config_mix_metric_and_kernel_are_new_files_only(tmp_path):
    """A later change adds a configuration, a traffic mix, a per-layer
    metric and a kernel's work as new files and new BENCHMARK.json entries:
    the harness finds them by name, with no file of bench_torch edited."""
    copy = tmp_path / "repo"
    shutil.copytree(BENCH, copy / "bench_torch", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(copy): p.read_bytes() for p in (copy / "bench_torch").rglob("*") if p.is_file()}
    b = dict(SPEC)
    new = copy / "bench_torch"
    conf = json.loads((BENCH / "configs" / "xbr-lv2-1080p.json").read_text())
    conf.update(name="xbr-lv2-720p", viewport=[1280, 720])
    (new / "configs" / "xbr-lv2-720p.json").write_text(json.dumps(conf))
    (new / "configs" / "xbr-lv2-720p.py").write_text((BENCH / "configs" / "xbr-lv2-1080p.py").read_text())
    mix = json.loads((BENCH / "traffic" / "live.json").read_text())
    mix["rate_hz"] = 120
    (new / "traffic" / "live120.json").write_text(json.dumps(mix))
    (new / "work" / "toy.py").write_text("def work(batch, src_hw, out_hw):\n    return 4 * batch, batch\n")
    (new / "metrics" / "kernel.toy.roofline_pct.py").write_text(
        "def read(r):\n    return r.bound_ms('toy')\n")
    b["configs"] = SPEC["configs"] + [dict(SPEC["configs"][1], name="xbr-lv2-720p",
                                           file="bench_torch/configs/xbr-lv2-720p.json")]
    b["workloads"] = SPEC["workloads"] + [{"name": "xbr-lv2-720p.live120", "config": "xbr-lv2-720p",
                                           "traffic": "live120", "chips": 1, "why": "a 120 frames/s stream"}]
    b["per_layer"] = SPEC["per_layer"] + [{"name": "kernel.toy.roofline_pct", "unit": "%", "better": "higher",
                                           "source": "device_trace", "layer": "hand kernels",
                                           "moves": "latency_p95_ms", "workloads": ["xbr-lv2-720p.live120"]}]
    # The open loop's end-to-end metrics cover the new cell too.
    b["end_to_end"] = [dict(m, workloads=m["workloads"] + ["xbr-lv2-720p.live120"])
                       if "crt-mattias-1080p.live" in m.get("workloads", []) else m for m in SPEC["end_to_end"]]
    cell = spec.resolve("xbr-lv2-720p.live120", bench=b, root=copy)
    assert cell.viewport == (1280, 720) and cell.traffic["rate_hz"] == 120
    assert {m["name"] for m in cell.per_layer} >= {"kernel.toy.roofline_pct"}
    assert callable(cell.reference().render) and callable(cell.preset_writer().write)
    assert cell.work("toy").work(2, (1, 1), (1, 1)) == (8, 2)
    assert callable(cell.reader("kernel.toy.roofline_pct").read)
    after = {p.relative_to(copy): p.read_bytes() for p in (copy / "bench_torch").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)
