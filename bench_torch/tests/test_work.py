"""The work formulas give the bounds the port's kernel table states at the
same shapes (PERF.md §6)."""

import pytest

from harness import peaks
from harness.spec import BENCH, load_module


@pytest.mark.parametrize("kernel, batch, src_hw, out_hw, bound_ms, by", [
    ("blur_groups", 32, (240, 320), (1080, 1920), 0.4457, "operations"),
    ("xbr_epilogue", 64, (240, 320), (1080, 1920), 1.1356, "bytes"),
])
def test_bound_at_the_table_shapes(kernel, batch, src_hw, out_hw, bound_ms, by):
    ms, got_by = peaks.bound(*load_module(BENCH / "work" / f"{kernel}.py").work(batch, src_hw, out_hw))
    assert got_by == by
    assert ms == pytest.approx(bound_ms, abs=0.0006)
