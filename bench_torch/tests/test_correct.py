"""What decides ``correct``: the control (the plain reference in the
precision below the configuration's) and the faults a cell can have must
read as not correct; a sound run must read as correct. On the CPU, at
each configuration's ``rehearse`` size, through the benchmark's own run
(``run_cell``) with the timed path broken underneath."""

import numpy as np
import pytest
import torch

from harness.cell import run_cell
from harness.compare import verdict
from harness.spec import BENCH, load_benchmark, load_module, resolve

calibrate = load_module(BENCH / "calibrate.py")
WORKLOADS = [w["name"] for w in load_benchmark()["workloads"]]
CONFIGS = sorted({w["config"] for w in load_benchmark()["workloads"]})


def tiny(workload):
    """The cell at its configuration's ``rehearse`` size, one answer in two
    compared, at least 4 of them."""
    conf = resolve(workload).config
    return resolve(workload, config=dict(conf["rehearse"], compare=dict(conf["compare"], frames=4)),
                   traffic={"sample_every": 2})


@pytest.mark.parametrize("config", CONFIGS)
def test_control_is_not_correct(config):
    """The reference in bfloat16 in the program's place, on three seeds."""
    cell = tiny(f"{config}.offline")
    for seed in (11, 12, 2**31 + 13):
        frames = calibrate.sampled_frames(cell, seed, 0, 12)
        numbers = calibrate.control_numbers(cell, seed, frames, "cpu")
        assert numbers["frames"] >= cell.config["compare"]["frames"] or numbers["frames"] == len(frames)
        ok, rows = verdict({k: v for k, v in numbers.items() if k != "frames"},
                           {k: v for k, v in cell.config["compare"].items() if k != "frames"})
        assert not ok, rows


def altered(process, e):
    """Every answer altered where it is produced: 3 levels up."""
    def f(frames):
        out = process(frames)
        return (torch.as_tensor(out).to(torch.int16) + 3).clamp(0, 255).to(torch.uint8).numpy() \
            if isinstance(out, np.ndarray) else (out.to(torch.int16) + 3).clamp(0, 255).to(torch.uint8)
    return f


def half_left_out(process, e):
    """Half of each batch left out: its second half answered with the first
    half's frames; in single frames, every other frame the one before."""
    last = []

    def f(frames):
        out = process(frames)
        if isinstance(out, np.ndarray):  # one frame (apply_u8)
            last.append(out)
            return last[-2] if len(last) % 2 == 0 else out
        out = out.clone()
        n = out.shape[0] // 2
        out[n:2 * n] = out[:n]
        return out
    return f


def state_unchanged(process, e):
    """A step that returns its state unchanged: FrameCount never advances."""
    def f(frames):
        saved, hosts = dict(e._states), dict(e._fc_hosts)
        out = process(frames)
        e._states.clear()
        e._states.update(saved)
        e._fc_hosts.clear()
        e._fc_hosts.update(hosts)
        return out
    return f


FAULTS = {"altered": altered, "half_left_out": half_left_out, "state_unchanged": state_unchanged}
# FrameCount is the only state of these one-pass chains, and only
# crt-mattias reads it: xbr-lv2 cannot have the third fault.
CAN_HAVE = {w: [f for f in FAULTS if f != "state_unchanged" or w.startswith("crt-mattias")] for w in WORKLOADS}


@pytest.mark.parametrize("workload, fault", [(w, f) for w in WORKLOADS for f in [None] + CAN_HAVE[w]])
def test_faults_are_not_correct(workload, fault):
    cell = tiny(workload)
    out = run_cell(cell, 21, 1.0, False, device="cpu", wrap=FAULTS[fault] if fault else None)
    assert out["correct"] is (fault is None), out["compared"]
