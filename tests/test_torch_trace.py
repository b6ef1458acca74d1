"""The port's spans and counters (``core/config.py``: ``timed``, ``count``,
the ``trace`` option): the spans of the fused algorithms nest under one
root a call, the first call on a graph flips it and builds its plan and
the next finds both, the plan and host-sync counters count what the loops do,
nothing is kept with ``trace`` off, the stamps are on torch.profiler's
clock, and the records are capped.  On the CPU at 2^9 vertices."""

import threading
import time

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as gt
from graphblas_tpu_torch import algorithms as AL
from graphblas_tpu_torch import testing as GT
from graphblas_tpu_torch.core import config as CFG
from graphblas_tpu_torch.core import convert as CV
from graphblas_tpu_torch.kernels import spmv_route as SPRT

PLAN_PARTS = ("spmv_plan.tile",)
# the indptr's fetch and sha256: saving and matching plans only
NOT_IN_A_BUILD = ("spmv_plan.fetch", "spmv_plan.digest")
ROOTS = {"sssp": "algorithms.sssp", "pagerank": "algorithms.pagerank_fused"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """At these sizes torch's CPU thread pool only adds waits."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def tracing():
    """Tracing on, from empty records; off and empty again afterwards."""
    gt.trace_reset()
    gt.set_option("trace", True)
    try:
        yield
    finally:
        gt.set_option("trace", False)
        gt.trace_reset()


@pytest.fixture(autouse=True)
def no_kept_flips_or_plans():
    """Each test starts with no kept flip or plan, so that test order
    changes no count."""
    for cache in (CV._reorients, SPRT._plans):
        cache.clear()


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(14)
    r, c, n = GT.rmat_edges(9, 8, rng)
    w = (rng.random(r.size) + 0.05).astype(np.float32)
    return gt.Matrix.from_coo(r, c, w, (n, n), dup="min", device="cpu")


def call(algo, A):
    """One fused call with a plan; returns (result, host checks made)."""
    if algo == "sssp":
        d = AL.sssp(A, 3, optimize=True)
        relax = sum(r.name == "kernels.spmv_route_monoid"
                    for r in gt.trace_records())
        return d, relax // 4
    ranks, steps = AL.pagerank_fused(A, 0.85, 1e-6, 100, optimize=True)
    return ranks, steps


def by_id(records):
    return {r.id: r for r in records}


def ancestors(rec, ids):
    out = []
    while rec.parent is not None:
        rec = ids[rec.parent]
        out.append(rec.name)
    return out


@pytest.mark.parametrize("algo", ["sssp", "pagerank"])
def test_spans_nest_under_one_root_a_call(graph, algo):
    call(algo, graph)
    call(algo, graph)
    recs = gt.trace_records()
    ids = by_id(recs)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [ROOTS[algo]] * 2
    for r in recs:
        assert r.root in {x.id for x in roots}
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            up = ids[r.parent]
            assert up.root == r.root
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns
    # the first call flips the graph and builds its plan, the second
    # finds both
    for root, flips in zip(roots, (1, 0)):
        mine = [r for r in recs if r.root == root.id]
        names = [r.name for r in mine]
        assert names.count("convert.reorient") == flips
        assert names.count("spmv_plan.build") == flips
        for part in PLAN_PARTS:
            parts = [r for r in mine if r.name == part]
            assert len(parts) == flips
            for rec in parts:
                assert ids[rec.parent].name == "spmv_plan.build"
                assert ROOTS[algo] in ancestors(rec, ids)
        assert not set(NOT_IN_A_BUILD) & set(names)
    c = gt.trace_counters()
    assert c["convert.reorients"] == 1
    assert c["convert.reorient_hits"] == 1
    assert c["spmv_plan.builds"] == 1


@pytest.mark.parametrize("algo", ["sssp", "pagerank"])
def test_counters_count_plans_reorients_and_host_syncs(graph, algo):
    _, checks = call(algo, graph)
    c = gt.trace_counters()
    assert checks >= 1
    assert c["spmv_plan.builds"] == 1
    assert c["spmv_plan.lookups"] >= 1
    assert c["convert.reorients"] == 1
    assert "convert.reorient_hits" not in c
    # each stop test, and nothing of the plan's build
    assert c["host_syncs"] == checks
    # the second call on the graph finds its flip and its plan
    gt.trace_reset()
    _, checks = call(algo, graph)
    c = gt.trace_counters()
    assert checks >= 1
    assert "spmv_plan.builds" not in c
    assert c["spmv_plan.lookups"] >= 1
    assert "convert.reorients" not in c
    assert c["convert.reorient_hits"] == 1
    assert c["host_syncs"] == checks


@pytest.mark.parametrize("algo", ["sssp", "pagerank"])
def test_trace_off_keeps_nothing_and_changes_no_bit(graph, algo):
    on, _ = call(algo, graph)
    gt.trace_reset()
    gt.set_option("trace", False)
    off, _ = call(algo, graph)
    CFG.count("host_syncs")
    assert gt.trace_records() == [] and gt.trace_counters() == {}
    assert GT.same_bits(on, off)


def test_span_stamps_are_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    x = torch.arange(4096, dtype=torch.float32).flip(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.cumsum(x, 0)
        time.sleep(0.002)
        with CFG.timed("unit.span"):
            torch.sort(x)
        time.sleep(0.002)
        torch.cumsum(x, 0)
    start = prof.profiler.kineto_results.trace_start_ns()
    (span,) = gt.trace_records()
    t0, t1 = span.start_ns - start, span.end_ns - start
    ev = {}
    for e in prof.profiler.kineto_results.events():
        ev.setdefault(e.name(), []).append(
            (e.start_ns() - start, e.start_ns() - start + e.duration_ns()))
    assert ev["aten::sort"]
    assert all(t0 <= a and b <= t1 for a, b in ev["aten::sort"])
    assert all(not (t0 <= a and b <= t1) for a, b in ev["aten::cumsum"])


def test_cap_drops_the_oldest_and_counts_them():
    extra = 5
    for _ in range(CFG.TRACE_CAP + extra):
        with CFG.timed("unit.cap"):
            pass
    recs = gt.trace_records()
    assert len(recs) == CFG.TRACE_CAP
    assert gt.trace_counters()["trace.dropped"] == extra
    ids = [r.id for r in recs]
    assert ids == sorted(ids) and ids[-1] - ids[0] == CFG.TRACE_CAP - 1
    CFG.GLOBAL.timing.pop("unit.cap")


def test_each_thread_nests_its_own_spans():
    inner = []

    def other():
        with CFG.timed("unit.thread"):
            inner.append(threading.get_ident())

    with CFG.timed("unit.main"):
        t = threading.Thread(target=other)
        t.start()
        t.join(10)
    assert not t.is_alive() and inner
    recs = {r.name: r for r in gt.trace_records()}
    assert recs["unit.thread"].parent is None
    assert recs["unit.thread"].root == recs["unit.thread"].id
    for k in ("unit.thread", "unit.main"):
        CFG.GLOBAL.timing.pop(k)
