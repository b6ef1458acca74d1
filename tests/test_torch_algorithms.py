"""Port parity: PageRank, BFS and SSSP (graphblas_tpu_torch.algorithms)
against graphblas_tpu on its XLA path and against scipy, plus the torch
twin of ``__graft_entry__.entry()``."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.csgraph as csg
import torch

import __graft_entry__ as jentry
import graphblas_tpu as gb
from graphblas_tpu import algorithms as jalg
from graphblas_tpu_torch import algorithms as talg
from graphblas_tpu_torch import entry as tentry
from torch_parity import cpu_default, pair, xla_path  # noqa: F401

N = 400


def _graph(seed, directed=True, weights=False):
    """A directed random graph with dangling and unreachable vertices;
    integer weights 1..20 when ``weights``."""
    rng = np.random.default_rng(seed)
    nnz = N * 3
    r = rng.integers(0, N - 20, nnz)      # last 20 vertices: no out-edges
    c = rng.integers(0, N, nnz)
    v = rng.integers(1, 21, nnz).astype(np.float64) if weights \
        else np.ones(nnz, np.float32)
    S = sps.csr_matrix((v, (r, c)), shape=(N, N))
    S.sum_duplicates()
    if not weights:
        S.data[:] = 1.0
    if not directed:
        S = (S + S.T).tocsr()
        S.data[:] = 1.0
    return S


def test_pagerank_grb_tier_matches(xla_path):
    """FP64 GrB-tier PageRank: 1e-10 relative to the JAX package."""
    Aj, At = pair(_graph(1))
    rj = np.asarray(jalg.pagerank(Aj, max_iter=30).to_dense_1d()[0])
    rt = talg.pagerank(At, max_iter=30).to_dense_1d()[0].numpy()
    assert rt.dtype == np.float64
    np.testing.assert_allclose(rt, rj, rtol=1e-10)


@pytest.mark.parametrize("optimize", [False, True])
def test_pagerank_fused_matches(xla_path, optimize):
    """FP32 fused PageRank, unplanned and planned: rtol 1e-5, atol 1e-7
    against the JAX fused tier; same iteration count."""
    Aj, At = pair(_graph(2))
    rj, itj = jalg.pagerank_fused(Aj, max_iter=40)
    rt, itt = talg.pagerank_fused(At, max_iter=40, optimize=optimize)
    assert int(itj) == itt
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5,
                               atol=1e-7)


def test_bfs_grb_tier_matches(xla_path):
    """Exact levels, absent = unreached, against JAX and scipy."""
    S = _graph(3)
    Aj, At = pair(S.astype(bool))
    lj = jalg.bfs_levels(Aj, 0)
    lt = talg.bfs_levels(At, 0)
    vj, pj = (np.asarray(a) for a in lj.to_dense_1d())
    vt, pt = (a.numpy() for a in lt.to_dense_1d())
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(vt[pt], vj[pj])
    d = csg.shortest_path(S, unweighted=True, indices=0)
    np.testing.assert_array_equal(pt, np.isfinite(d))
    np.testing.assert_array_equal(vt[pt], d[pt].astype(np.int32))


@pytest.mark.parametrize("optimize", [False, True])
def test_bfs_fused_matches(xla_path, optimize):
    S = _graph(4, directed=False)
    Aj, At = pair(S)
    lj = np.asarray(jalg.bfs_levels_fused(Aj, 7))
    lt = talg.bfs_levels_fused(At, 7, optimize=optimize).numpy()
    np.testing.assert_array_equal(lt, lj)


@pytest.mark.parametrize("optimize", [False, True])
def test_sssp_matches(xla_path, optimize):
    """Integer weights: exact against the JAX fused tier (max_iter None,
    no cached plan on the JAX side) and against scipy's Dijkstra."""
    S = _graph(5, weights=True)
    Aj, At = pair(S)
    dj = np.asarray(jalg.graph.sssp(Aj, 0))
    dt = talg.sssp(At, 0, optimize=optimize)
    assert dt.dtype == torch.float64
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_array_equal(dt.numpy(),
                                  csg.dijkstra(S, indices=0))


def test_entry_step_matches_graft_entry():
    """One PageRank step of the torch entry point vs the JAX one:
    rtol 1e-6 (fp32, summation order)."""
    fj, aj = jentry.entry()
    ft, at = tentry.entry()
    for a, b in zip(aj[1:], at[1:]):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    yj = np.asarray(fj(*aj))
    yt = ft(*at)
    assert yt.dtype == torch.float32
    np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-6)
    y2j = np.asarray(fj(jnp.asarray(yj), *aj[1:]))
    y2t = ft(yt, *at[1:]).numpy()
    np.testing.assert_allclose(y2t, y2j, rtol=1e-6)


def _components_graph(seed, weights=False):
    """Three blocks of the random graph with no edge between them, plus
    isolated vertices: several weak components."""
    S = _graph(seed, weights=weights)
    rng = np.random.default_rng(seed)
    keep = (S.tocoo().row // 150) == (S.tocoo().col // 150)
    C = S.tocoo()
    S = sps.csr_matrix((C.data[keep], (C.row[keep], C.col[keep])),
                       shape=S.shape)
    S.data[:] = rng.integers(1, 21, S.nnz) if weights else 1.0
    return S


GRAPHS = {"random": lambda w: _graph(6, weights=w),
          "components": lambda w: _components_graph(7, weights=w)}


@pytest.mark.parametrize("g", list(GRAPHS))
def test_bfs_parents_matches(xla_path, g):
    """MIN_FIRSTJ parents: exact against JAX; each parent is an
    in-neighbour one level up (scipy's levels)."""
    S = GRAPHS[g](False)
    Aj, At = pair(S)
    pj = jalg.graph.bfs_parents(Aj, 3)
    pt = talg.bfs_parents(At, 3)
    assert pt.dtype.name == "GrB_INT64"
    vj, qj = (np.asarray(a) for a in pj.to_dense_1d())
    vt, qt = (a.numpy() for a in pt.to_dense_1d())
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(vt[qt], vj[qj])
    lv = csg.shortest_path(S, unweighted=True, indices=3)
    np.testing.assert_array_equal(qt, np.isfinite(lv))
    kids = np.flatnonzero(qt & (np.arange(N) != 3))
    assert (lv[vt[kids]] == lv[kids] - 1).all()
    assert all(S[p, k] for p, k in zip(vt[kids], kids))


@pytest.mark.parametrize("g", list(GRAPHS))
def test_connected_components_matches(xla_path, g):
    """FastSV labels equal JAX's and are the least vertex of each of
    scipy's weak components."""
    S = GRAPHS[g](False)
    Aj, At = pair(S)
    lj = np.asarray(jalg.graph.connected_components(Aj))
    lt = talg.connected_components(At)
    assert lt.dtype == torch.int32
    np.testing.assert_array_equal(lt.numpy(), lj)
    nc, lab = csg.connected_components(S, connection="weak")
    least = np.array([np.flatnonzero(lab == c).min() for c in range(nc)])
    np.testing.assert_array_equal(lt.numpy(), least[lab])
    assert nc > 1 or g == "random"


@pytest.mark.parametrize("g", list(GRAPHS))
def test_sssp_grb_matches(xla_path, g):
    """The GrB tier's min-plus vxm + ewise_add MIN loop: exact against
    JAX and scipy's Dijkstra (integer weights)."""
    S = GRAPHS[g](True)
    Aj, At = pair(S)
    dj = jalg.graph.sssp_grb(Aj, 3)
    dt = talg.sssp_grb(At, 3)
    assert dt.dtype.name == "GrB_FP64"
    vj, qj = (np.asarray(a) for a in dj.to_dense_1d())
    vt, qt = (a.numpy() for a in dt.to_dense_1d())
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(vt[qt], vj[qj])
    ref = csg.dijkstra(S, indices=3)
    np.testing.assert_array_equal(qt, np.isfinite(ref))
    np.testing.assert_array_equal(vt[qt], ref[qt])
