"""On the card: a small cell end to end with its spans, its profiler
stretch and its comparison.  Skips where there is no card."""

import time

import pytest

from gbbench import catalog, run


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kron.sssp", "urand.pr"])
def test_small_cell_on_the_card(card, workload):
    cell = catalog.cell(workload)
    res = run.run_cell(cell, 2**31 + 7, 2.0, True, card,
                       time.perf_counter(), scale=16, log=lambda s: None)
    assert res["correct"]
    assert res["trace"]["busy_s"] > 0
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < res["metrics"]["spmv_roofline_pct"]["value"] <= 100


@pytest.mark.cuda
def test_urand_sssp_control_fails_at_its_own_size(card):
    """GAP's integer weights: bfloat16 is exact below 256, so only the
    cell's own scale, whose farthest vertices lie at 253-305, tells the
    control from the program (seed 2147500013: every one of the first
    three roots reads 3.9e-3 under bfloat16; the window's first calls
    are always judged)."""
    import torch
    cell = catalog.cell("urand.sssp")
    res = run.run_cell(cell, 2147500013, 2.0, False, card,
                       time.perf_counter(), log=lambda s: None,
                       control=[torch.bfloat16])
    assert res["correct"]
    assert res["checks"]["max_rel_gap"]["value"] == 0.0
    assert res["controls"]["bfloat16"]["correct"] is False
