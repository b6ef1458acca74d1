"""The roofline's bytes and the idle share, on synthetic inputs."""

import pytest

from gbbench import roofline, trace


def test_spmv_bytes_count_each_array_once():
    m, n, nnz = 1000, 800, 5000
    want = 4 * (m + 1) + 4 * nnz + 4 * nnz + 4 * n + 4 * m
    assert roofline.spmv_bytes(m, n, nnz, 4, 4) == want
    assert roofline.spmv_bytes(m, n, nnz, 8, 8) == \
        4 * (m + 1) + 12 * nnz + 8 * (n + m)
    assert roofline.spmv_ops(nnz) == 2 * nnz


@pytest.mark.parametrize("values", [False, True])
def test_spmv_roofline_bytes_come_from_the_matrix_and_the_mix(values):
    """Pattern products (PageRank) need no values; min-plus SSSP reads
    4 B of weight per entry.  Nothing comes from the program's plan."""
    from gbbench import catalog

    class FakeRun:
        shape, nnz = (1000, 800), 5000
        config = {"value_dtype": "float32"}
        traffic = {"spmv_values": values}
    got = catalog.module("metrics", "spmv_roofline_pct").call_bytes(FakeRun)
    assert got == 4 * 801 + (8 if values else 4) * 5000 + 4 * (1000 + 800)


def test_least_time_takes_the_binding_bound():
    assert roofline.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_s(0, 67e12) == pytest.approx(1.0)
    # scale 24 SpMV: 0.5 G entries bind on bytes, not operations
    b = roofline.spmv_bytes(2**24, 2**24, 520_000_000, 4, 4)
    assert roofline.least_s(b, roofline.spmv_ops(520_000_000)) == \
        pytest.approx(b / 3.35e12)


def test_union_counts_overlap_once():
    assert trace.merged([(5, 6), (0, 2), (1, 3)]) == [[0, 3], [5, 6]]
    assert trace.gaps([[0, 3], [5, 6]], 0, 10) == [(3, 5), (6, 10)]
    assert trace.gaps([[0, 3]], 1, 2) == []


def test_reduce_trace_busy_idle_and_gap_labels():
    device = [(10, 20, "k1"), (15, 30, "k1"), (60, 70, "k2")]
    host = [(0, 100, "gbbench:call"), (30, 60, "gbbench:spmv_route.build_plan"),
            (40, 50, "aten::copy_")]
    r = trace.reduce_trace(device, host, 0, 100)
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["window_s"] == pytest.approx(100e-6)
    ops = dict(r["breakdown"]["device_ops"])
    assert ops == {"k1": pytest.approx(25e-6), "k2": pytest.approx(10e-6)}
    gaps = dict(r["breakdown"]["idle_gaps"])
    assert gaps["spmv_route.build_plan > aten::copy_"] == pytest.approx(30e-6)
    assert gaps["call"] == pytest.approx(40e-6)         # [0, 10), [70, 100)
    assert sum(gaps.values()) == pytest.approx(70e-6)


def test_reduce_trace_clips_to_the_stretch():
    r = trace.reduce_trace([(0, 50, "k")], [], 40, 60)
    assert r["busy_s"] == pytest.approx(10e-6)
    assert dict(r["breakdown"]["idle_gaps"]) == {
        "(no host span)": pytest.approx(10e-6)}


def test_idle_pct_reads_the_stretch():
    from gbbench import catalog

    class FakeRun:
        cuda = True
        trace = {"busy_s": 0.25, "window_s": 1.0}
    read = catalog.module("metrics", "idle_pct").install(FakeRun())
    assert read() == pytest.approx(75.0)
    FakeRun.trace = None
    assert read() is None


def test_patches_wrap_and_restore():
    import types
    mod = types.ModuleType("fake_program")
    mod.f = lambda x: x + 1
    orig = mod.f
    p = trace.Patches()
    seen = []

    def make(fn):
        def g(x):
            seen.append(x)
            return fn(x)
        return g
    assert p.wrap(mod, "f", make)
    assert not p.wrap(mod, "missing", make)
    assert mod.f(1) == 2 and seen == [1]
    p.restore()
    assert mod.f is orig
