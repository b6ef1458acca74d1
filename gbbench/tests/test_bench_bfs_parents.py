"""Graph500 kernel 2's cell ``kron.bfs_parents``: found by name, and on the
card a small run of it end to end with every per-layer metric read."""

import time

import pytest

from gbbench import catalog, run

CELL = "kron.bfs_parents"
METRICS = {"bfsp_spmm_ms", "bfsp_writeback_ms", "bfsp_products",
           "bfsp_host_syncs", "bfsp_idle_pct", "bfsp_roofline_pct"}


def test_cell_resolves_by_name():
    cell = catalog.cell(CELL)
    assert cell.workload["chips"] == 1
    assert cell.config["name"] == "graph500-kron-bfs"
    assert cell.config["scale"] == 24
    assert cell.traffic["call"] == cell.traffic["reference"] == "bfs_parents"
    assert cell.traffic["limits"] == {"parent_mismatch": 0,
                                      "reach_mismatch": 0}
    assert [m["name"] for m in cell.end_to_end] == ["trial_ms", "setup_s"]
    assert {m["name"] for m in cell.per_layer} == METRICS
    assert all(m["moves"] == "trial_ms" for m in cell.per_layer)
    calls = catalog.module("calls", "bfs_parents")
    assert callable(calls.inputs) and callable(calls.call)
    ref = catalog.module("reference", "bfs_parents")
    assert all(callable(getattr(ref, f)) for f in ("prepare", "solve",
                                                   "compare"))
    for m in METRICS:
        assert callable(catalog.module("metrics", m).install)


@pytest.mark.cuda
def test_small_bfs_parents_cell_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = catalog.cell(CELL)
    res = run.run_cell(cell, 2**33 + 17, 2.0, True, torch.device("cuda"),
                       time.perf_counter(), scale=16, log=lambda s: None)
    assert res["correct"]
    assert res["checks"]["parent_mismatch"]["value"] == 0
    assert res["trace"]["busy_s"] > 0
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(got) == METRICS and None not in got.values()
    assert 0 < got["bfsp_roofline_pct"] <= 100
    assert got["bfsp_products"] > 0 and got["bfsp_host_syncs"] >= 2
