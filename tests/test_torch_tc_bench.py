"""Triangle counting at the benchmark's cell ``kron.tc``, on the CPU: the
plain reference ``gbbench/reference/triangles.py`` against scipy, the
port's ``triangle_count`` against the reference on the cell's own graphs
(built as ``gbbench/run.py`` builds them), the comparison's limit, the
degree relabelling of L, the SELL engine's fused count with its
fallback rows, and the count's spans, counters and host syncs.  Counts
are exact."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.algorithms import graph as TG
from graphblas_tpu_torch.core import semiring as TS
from graphblas_tpu_torch.ops import spgemm_sell as SGS
from gbbench import catalog, graph, tc
from torch_parity import cpu_default, tc_scipy  # noqa: F401

CFG = catalog.load_json(catalog.HERE / "configs" / "graph500-kron-tc.json")
REF = catalog.module("reference", "triangles")
SEEDS = (7, 2**31 + 99, 2**40 + 3)


@pytest.fixture(autouse=True)
def one_thread():
    """torch's default CPU thread pool makes these small calls slow."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def traced():
    gt.trace_reset()
    gt.set_option("trace", True)
    yield gt.trace_counters
    gt.set_option("trace", False)
    gt.trace_reset()


def edges_of(scale, seed):
    return graph.generate(CFG, seed, "cpu", scale)


def scipy_pattern(e):
    r, c, _ = graph.stored(e, CFG)
    S = sps.csr_matrix((np.ones(r.numel()), (r.numpy(), c.numpy())),
                       shape=(e.n, e.n))
    S.sum_duplicates()
    S.data[:] = 1
    return S


def built(e):
    """The program's matrix as ``gbbench/run.py`` builds it."""
    rows, cols, vals = graph.stored(e, CFG)
    return gt.Matrix.from_coo(rows, cols, vals, (e.n, e.n),
                              dup=CFG["duplicates"], orient=gt.ROW)


def reference(e, dtype=torch.float64):
    return REF.solve(REF.prepare(e, CFG, {}, dtype), None, {}, dtype)


@pytest.mark.parametrize("scale", (8, 9, 10, 11))
@pytest.mark.parametrize("seed", SEEDS)
def test_reference_matches_scipy(scale, seed):
    e = edges_of(scale, seed)
    S = scipy_pattern(e)
    want = (S @ S).multiply(S).sum() / 6
    assert want > 0
    assert reference(e) == want


@pytest.mark.parametrize("scale", (8, 9, 10, 11))
@pytest.mark.parametrize("seed", SEEDS)
def test_port_matches_reference(scale, seed):
    e = edges_of(scale, seed)
    A = built(e)
    want = reference(e)
    assert gt.triangle_count(A) == want
    assert gt.triangle_count(A) == want          # L, L' from the cache


def test_compare_flags_an_off_by_one_count():
    assert REF.compare(1000, 1000.0, None) == {"count_gap": 0.0}
    assert REF.compare(1001, 1000.0, None)["count_gap"] == 1.0
    assert REF.compare(999, 1000.0, None)["count_gap"] == 1.0


def test_wedges_are_the_references_enumeration():
    """``gbbench.tc.work`` counts the wedges the reference closes, from
    the program's matrix alone, and L's index bytes read twice."""
    e = edges_of(10, SEEDS[0])
    A = built(e)
    nbytes, wedges = tc.work(A.indptr, A.indices, A.nrows)
    st = REF.prepare(e, CFG, {}, torch.float64)
    per = st["indptr"][st["src"] + 1] - 1 - torch.arange(st["src"].numel())
    assert wedges == int(per.sum())
    assert nbytes == 2 * 4 * (e.n + 1 + A.nvals // 2)


def skewed_graph(seed, n=2000, active=900, edges=12000, symmetric=True):
    """More than half of the vertices isolated and ten hubs at the ends of
    three edges in ten: the mean degree is above 10 and above 4 x the
    median (0), LAGraph's rule for a presort."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(n, active, replace=False)
    r = ids[rng.integers(0, active, edges)]
    c = ids[np.where(rng.random(edges) < 0.3, rng.integers(0, 10, edges),
                     rng.integers(0, active, edges))]
    S = sps.csr_matrix((np.ones(edges, np.float32), (r, c)), shape=(n, n))
    if symmetric:
        S = S + S.T
    S.sum_duplicates()
    S.data[:] = 1
    return S


@pytest.mark.parametrize("symmetric", (True, False))
def test_degree_relabelled_count_is_exact(traced, symmetric):
    """The count is that of the undirected graph of tril(A, -1)'s
    entries, whatever the labels: relabelled by degree it is the same,
    on a symmetric pattern and on a directed one, and the relabelled L
    expands fewer products."""
    S = skewed_graph(5, edges=12000 if symmetric else 24000,
                     symmetric=symmetric)
    A = gt.Matrix.from_scipy(S)
    assert gt.triangle_count(A) == tc_scipy(S) > 0
    assert traced().get("tc.degree_sorts") == 1
    L0 = gt.select(A, gt.operators.TRIL, -1)
    L = TG._degree_ordered(L0)
    assert L.nvals == L0.nvals

    def flops(L):
        return int(np.diff(L.to_scipy().T.tocsr().indptr)[
            L.to_scipy().indices].sum())
    assert flops(L) < flops(L0)


def test_small_or_even_degrees_keep_their_labels():
    e = edges_of(11, SEEDS[0])                    # mean 22 < 4 x median
    L0 = gt.select(built(e), gt.operators.TRIL, -1)
    assert TG._degree_ordered(L0) is L0
    S = skewed_graph(6, n=900, active=400, edges=5000)       # n <= 1000
    L0 = gt.select(gt.Matrix.from_scipy(S), gt.operators.TRIL, -1)
    assert TG._degree_ordered(L0) is L0


def test_fused_count_keeps_its_fallback_rows_out_of_the_slot_domain(
        monkeypatch):
    """The fused PAIR count holds no fallback output, so a slot limit just
    above SELL's own slots, which declines the materialised product,
    leaves the count on SELL, its fallback rows counted block by block
    (no sort) with the classic path's product blocks cut small."""
    from graphblas_tpu_torch.ops import mxm as TMXM
    S = skewed_graph(7)
    A = gt.Matrix.from_scipy(S)
    L = gt.select(A, gt.operators.TRIL, -1)
    LT = gt.transpose(L).to_format(gt.SPARSE, gt.ROW)
    d = gt.Descriptor(mask_structure=True)
    msgs = []
    gt.set_option("printf", msgs.append)
    gt.set_option("burble", True)
    try:
        want = int(gt.mxm_reduce_scalar(L, LT, TS.PLUS_PAIR, mask=L,
                                        desc=d))
        line = next(m for m in msgs if " padded slots, " in m)
        d_pad = int(line.split(" blocks, ")[1].split()[0])
        assert int(line.split(", ")[-1].split()[0]) > 0   # fallback rows
        monkeypatch.setattr(SGS, "MAX_SLOTS", d_pad + 1)
        monkeypatch.setattr(TMXM, "SPGEMM_FLOP_BLOCK", 1 << 10)
        L = gt.select(gt.Matrix.from_scipy(S), gt.operators.TRIL, -1)
        LT = gt.transpose(L).to_format(gt.SPARSE, gt.ROW)
        del msgs[:]
        got = gt.mxm_reduce_scalar(L, LT, TS.PLUS_PAIR, mask=L, desc=d)
        assert not any("declined" in m for m in msgs)
        assert not any("mask prefilter" in m for m in msgs)    # no sort
        C = gt.mxm(L, LT, TS.PLUS_PAIR, mask=L, desc=d)
        assert any("SELL declined (slot domain)" in m for m in msgs)
    finally:
        gt.set_option("burble", False)
    assert int(got) == want == tc_scipy(S)
    assert int(C.to_scipy().sum()) == want


def test_fused_reduce_declines_a_bitmap_mask():
    """The tiers apply a sparse mask only: with a bitmap mask the fused
    reduce declines and mxm's writeback masks."""
    S = skewed_graph(8)
    A = gt.Matrix.from_scipy(S)
    M = A.to_format(gt.BITMAP)
    d = gt.Descriptor(mask_structure=True)
    assert gt.mxm_reduce_scalar(A, A, TS.PLUS_PAIR, mask=M, desc=d) is None
    C = gt.mxm(A, A, TS.PLUS_PAIR, mask=M, desc=d)
    P = S.astype(np.int64)
    assert int(C.to_scipy().sum()) == int((P @ P).multiply(P).sum())


@pytest.mark.parametrize("scale, fallback", ((8, False), (11, True)))
def test_count_opens_its_spans_and_counts_its_host_syncs(traced, scale,
                                                         fallback):
    """A warm count (L, L' and SELL's prep cached) opens the root span,
    the flop count's and SELL's, counts the SELL tier, and one host sync
    a host copy: the flop total, A's row pointers, the count read back,
    and where hub rows fall back their upload and their block cut."""
    seed = {8: SEEDS[1], 11: SEEDS[0]}[scale]
    A = built(edges_of(scale, seed))
    gt.triangle_count(A)
    gt.trace_reset()
    gt.triangle_count(A)
    c = traced()
    names = {r.name for r in gt.trace_records()}
    assert {"algorithms.triangle_count", "spgemm.flops", "spgemm.sell.prep",
            "spgemm.sortreduce"} <= names
    assert "algorithms.triangle_count.prep" not in names
    assert c["tc.cache_hits"] == 1 and "tc.cache_builds" not in c
    assert c["spgemm.sell"] == 1
    assert "spgemm.sell.prep_builds" not in c
    assert ("spgemm.fallback" in names) == fallback
    assert (c.get("spgemm.fallback_rows", 0) > 0) == fallback
    assert c["host_syncs"] == (5 if fallback else 3)


def test_a_window_call_past_the_cells_limit_stops_the_run(monkeypatch):
    """The cell's call stops a run whose window call takes longer than its
    limit (the warm call, which carries the first builds, has none)."""
    calls = catalog.module("calls", "triangle_count")
    A = built(edges_of(8, SEEDS[0]))
    keys, warm = calls.inputs(None, CFG, 1)
    monkeypatch.setattr(calls, "MAX_CALL_S", 0.0)
    want = calls.call(A, warm, {})
    assert want == reference(edges_of(8, SEEDS[0]))
    with pytest.raises(RuntimeError, match="more than the cell's"):
        calls.call(A, keys[0], {})


def test_the_reference_imports_only_torch():
    """The plain reference stands apart from the program and from JAX."""
    import ast
    tree = ast.parse((catalog.HERE / "reference" / "triangles.py")
                     .read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names == {"__future__", "torch"}
