"""Graph500 kernel 2 at the benchmark's cell ``kron.bfs_parents``, on the
CPU: the plain reference ``gbbench/reference/bfs_parents.py`` against
scipy's BFS levels, the port's ``bfs_parents`` against the reference on
the cell's own graphs (built as ``gbbench/run.py`` builds them), the
lower-precision control, the cell's roots and call limit, the roofline's
components, and the search's spans, counters and host syncs.  Parents
are exact."""

import ast

import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.csgraph as csg
import torch

import graphblas_tpu_torch as gt
from gbbench import bfs, catalog, graph, roofline
from torch_parity import cpu_default  # noqa: F401

CFG = catalog.load_json(catalog.HERE / "configs" / "graph500-kron-bfs.json")
REF = catalog.module("reference", "bfs_parents")
CALLS = catalog.module("calls", "bfs_parents")
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


def reference(e, root, dtype=torch.float64):
    return REF.solve(REF.prepare(e, CFG, {}, dtype), root, {}, dtype)


def roots_of(S, count=3):
    """The vertex of highest degree, other vertices with edges, and one in
    the smallest component that has an edge."""
    deg = np.diff(S.indptr)
    _, lab = csg.connected_components(S, directed=False)
    sizes = np.bincount(lab)
    small = np.flatnonzero((sizes[lab] == sizes[lab[deg > 0]].min())
                           & (deg > 0))
    with_edges = np.flatnonzero(deg > 0)
    picks = [int(np.argmax(deg)), int(small[0])]
    picks += [int(v) for v in with_edges[:: max(1, with_edges.size // count)]
              [:count]]
    return list(dict.fromkeys(picks)), sizes[lab]


def dense(v):
    vals, pres = v.to_dense_1d()
    return torch.where(pres, vals, torch.full_like(vals, -1))


@pytest.mark.parametrize("seed", SEEDS)
def test_reference_is_the_least_parent_one_level_up(seed):
    """Each reached vertex but the root takes the least neighbour one of
    scipy's levels up, and the reached set is scipy's."""
    e = edges_of(10, seed)
    S = scipy_pattern(e)
    state = REF.prepare(e, CFG, {}, torch.float64)
    for root in roots_of(S)[0]:
        got = REF.solve(state, root, {}, torch.float64).numpy()
        lv = csg.shortest_path(S, unweighted=True, indices=root)
        np.testing.assert_array_equal(got >= 0, np.isfinite(lv))
        assert got[root] == root
        kids = np.flatnonzero((got >= 0) & (np.arange(e.n) != root))
        for k in kids:
            nbrs = S.indices[S.indptr[k]:S.indptr[k + 1]]
            assert got[k] == nbrs[lv[nbrs] == lv[k] - 1].min()


@pytest.mark.parametrize("scale, seed, small", (
    (9, SEEDS[2], True), (10, SEEDS[0], True), (11, SEEDS[1], False)))
def test_port_matches_reference(scale, seed, small):
    """From the vertex of highest degree, a root in the smallest component
    and others: the port's parents are the reference's, and a search
    reaches its root's component alone (the first two graphs hold a
    component of two vertices beside the giant one)."""
    e = edges_of(scale, seed)
    A = built(e)
    state = REF.prepare(e, CFG, {}, torch.float64)
    roots, reach = roots_of(scipy_pattern(e))
    for root in roots:
        got = dense(gt.bfs_parents(A, root))
        want = REF.solve(state, root, {}, torch.float64)
        assert REF.compare(got, want, root) == {"parent_mismatch": 0.0,
                                                "reach_mismatch": 0.0}
        assert int((got >= 0).sum()) == reach[root]
    assert (reach[roots[1]] == 2) == small


def test_bfloat16_control_fails_on_ids_past_256():
    e = edges_of(11, SEEDS[0])
    root = roots_of(scipy_pattern(e))[0][0]
    want = reference(e, root)
    got = reference(e, root, torch.bfloat16)
    nums = REF.compare(got, want, root)
    assert nums["parent_mismatch"] > 0
    assert nums["reach_mismatch"] == 0
    assert REF.compare(want, want, root) == {"parent_mismatch": 0.0,
                                             "reach_mismatch": 0.0}


def test_levels_spans_products_and_host_syncs(traced):
    """A search opens its root span, a level span, an ``mxm.spmm`` and a
    ``masker.writeback`` a level; counts depth + 1 levels, the matrix's
    stored entries expanded each level, and one host sync a level (its
    ``frontier.nvals``)."""
    e = edges_of(10, SEEDS[1])
    A = built(e)
    S = scipy_pattern(e)
    root = roots_of(S)[0][0]
    gt.bfs_parents(A, root)
    gt.trace_reset()
    gt.bfs_parents(A, root)
    c = traced()
    recs = gt.trace_records()
    by = {}
    for r in recs:
        by[r.name] = by.get(r.name, 0) + 1
    lv = csg.shortest_path(S, unweighted=True, indices=root)
    levels = int(lv[np.isfinite(lv)].max()) + 1
    assert c["bfs_parents.levels"] == levels
    assert c["mxm.spmm_products"] == levels * A.nvals
    assert c["host_syncs"] == levels
    assert by["algorithms.bfs_parents"] == 1
    assert by["algorithms.bfs_parents.level"] == levels
    assert by["mxm.spmm"] == levels
    assert by["masker.writeback"] >= levels
    assert by["ewise.add"] == levels - 1
    root_id = next(r.id for r in recs if r.name == "algorithms.bfs_parents")
    assert all(r.root == root_id for r in recs)


def test_trace_off_keeps_no_record():
    e = edges_of(9, SEEDS[0])
    A = built(e)
    gt.trace_reset()
    gt.bfs_parents(A, roots_of(scipy_pattern(e))[0][0])
    assert gt.trace_records() == [] and gt.trace_counters() == {}


def test_nvals_of_a_bitmap_is_one_host_sync(traced):
    v = gt.Vector.from_dense_masked(torch.arange(6)[:, None],
                                    (torch.arange(6) % 2 == 0)[:, None])
    assert v.nvals == 3 and v.nvals == 3          # the count is kept
    assert traced()["host_syncs"] == 1


def test_roots_are_64_distinct_vertices_with_edges():
    e = edges_of(11, SEEDS[2])
    roots, warm = CALLS.inputs(e, CFG, SEEDS[2])
    assert len(roots) == CALLS.ROOTS == 64
    assert isinstance(warm, CALLS.Warm)
    assert len(set(roots) | {int(warm)}) == 65
    has = graph.has_edges(e, CFG)
    assert all(bool(has[r]) for r in roots + [int(warm)])
    assert CALLS.inputs(e, CFG, SEEDS[2]) == (roots, warm)
    assert CALLS.inputs(e, CFG, SEEDS[0])[0] != roots


def test_a_window_call_past_the_cells_limit_stops_the_run(monkeypatch):
    e = edges_of(9, SEEDS[0])
    A = built(e)
    roots, warm = CALLS.inputs(e, CFG, SEEDS[0])
    monkeypatch.setattr(CALLS, "MAX_CALL_S", 0.0)
    got = CALLS.call(A, warm, {})
    assert torch.equal(got, reference(e, int(warm)))
    with pytest.raises(RuntimeError, match="more than the cell's"):
        CALLS.call(A, roots[0], {})


def test_components_and_least_time_from_the_pattern():
    """The roofline's reach is scipy's component size; its least time is
    12 bytes a reached vertex less 4, at the HBM rate."""
    e = edges_of(10, SEEDS[0])
    A = built(e)
    labels = bfs.components(A.indptr, A.indices, A.nrows)
    _, lab = csg.connected_components(scipy_pattern(e), directed=False)
    least = np.array([np.flatnonzero(lab == c).min()
                      for c in range(lab.max() + 1)])
    np.testing.assert_array_equal(labels.numpy(), least[lab])
    assert bfs.least_s(1) == roofline.least_s(8, 0)
    assert bfs.least_s(1000) == roofline.least_s(12 * 1000 - 4, 0)


def test_the_reference_imports_only_torch():
    """The plain reference stands apart from the program and from JAX."""
    tree = ast.parse((catalog.HERE / "reference" / "bfs_parents.py")
                     .read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert names == {"__future__", "torch"}
