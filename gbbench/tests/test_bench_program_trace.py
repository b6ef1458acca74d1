"""The per-layer metrics that read the program's own spans and counters:
a small traced run on the CPU reports them, and a program without the
facility gives them nothing to read (no raise)."""

import time

import pytest
import torch

from gbbench import catalog, run

NEW = ("plan_fetch_ms", "plan_digest_ms", "plan_builds", "host_syncs")


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
    from graphblas_tpu_torch.core import config
    config.set_option("trace", False)
    config.trace_reset()


def traced_small(workload):
    return run.run_cell(catalog.cell(workload), 2**33 + 5, 0.5, True,
                        "cpu", time.perf_counter(), scale=10,
                        log=lambda s: None)


@pytest.mark.parametrize("workload", ["kron.sssp", "urand.pr"])
def test_traced_run_reads_the_programs_spans_and_counters(workload):
    res = traced_small(workload)
    m = {k: v["value"] for k, v in res["metrics"].items()}
    assert res["correct"] and set(NEW) <= set(m)
    assert m["plan_builds"] == 1.0
    assert 0 < m["plan_fetch_ms"] + m["plan_digest_ms"] <= m["plan_ms"]
    per_check = 4 if workload.endswith("sssp") else 1
    assert m["host_syncs"] == pytest.approx(m["spmv_calls"] / per_check + 2)


def test_a_program_without_the_trace_gives_nothing(monkeypatch):
    from graphblas_tpu_torch.core import config
    monkeypatch.delattr(config, "trace_records")
    for name in NEW:
        assert catalog.module("metrics", name).install(object()) is None
