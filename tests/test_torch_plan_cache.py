"""The port's one SpMV plan cache (``kernels/spmv_route.py: plan_for``, a
``TensorCache``): a second call on a graph finds the plan its first call
built, an entry goes with the graph's arrays, an in-place write to the
weights voids it, and a plan on other values of the same arrays reuses
the tiling.  On the CPU at 2^8 vertices, against the JAX package on its
XLA path."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.sparse.csgraph as csg
import torch

import graphblas_tpu_torch as gt
from graphblas_tpu import algorithms as jalg
from graphblas_tpu.ops.mxm import spmv_arrays as j_spmv_arrays
from graphblas_tpu_torch import algorithms as AL
from graphblas_tpu_torch import testing as GT
from graphblas_tpu_torch.core import convert as CV
from graphblas_tpu_torch.kernels import spmv_route as SPRT
from torch_parity import cpu_default, pair, xla_path  # noqa: F401

SCALE = 8


@pytest.fixture(autouse=True)
def no_kept_flips_or_plans():
    for cache in (CV._reorients, SPRT._plans):
        cache.clear()


def _csr(weights):
    """An undirected RMAT graph as scipy CSR with weights 1..20 (exact in
    fp32 sums: "float" fp32, "int32") or all 2 ("iso", int32)."""
    rng = np.random.default_rng(19)
    r, c, n = GT.rmat_edges(SCALE, 8, rng)
    keep = r != c
    r, c = np.concatenate([r[keep], c[keep]]), np.concatenate([c[keep],
                                                               r[keep]])
    w = rng.integers(1, 21, r.size) if weights != "iso" \
        else np.full(r.size, 2)
    S = sps.csr_matrix((w.astype(np.int32), (r, c)), shape=(n, n))
    S.sum_duplicates()
    if weights == "iso":
        S.data[:] = 2
    return S.astype(np.float32) if weights == "float" else S


def _by_col(S, iso):
    """The port's copy of S stored by column (iso: one stored value)."""
    if not iso:
        return gt.Matrix.from_scipy(S, orient=gt.COL)
    C = S.tocoo()
    return gt.Matrix.from_coo(C.row, C.col, C.data[:1].copy(), S.shape,
                              orient=gt.COL, iso=True)


def _traced(fn):
    """fn()'s result and the counters it added."""
    gt.trace_reset()
    gt.set_option("trace", True)
    try:
        out = fn()
        return out, gt.trace_counters()
    finally:
        gt.set_option("trace", False)
        gt.trace_reset()


CALLS = {
    "pagerank": (lambda A: AL.pagerank_fused(A, max_iter=30,
                                             optimize=True)[0],
                 lambda Aj: jalg.pagerank_fused(Aj, max_iter=30)[0]),
    "sssp": (lambda A: AL.sssp(A, 0, optimize=True),
             lambda Aj: jalg.graph.sssp(Aj, 0)),
    "bfs": (lambda A: AL.bfs_levels_fused(A, 0, optimize=True),
            lambda Aj: jalg.bfs_levels_fused(Aj, 0)),
    "mxv": (lambda A: gt.mxv(A.optimize(), gt.Vector.from_dense(
                torch.linspace(-1, 1, A.ncols)), gt.semiring.PLUS_TIMES)
            .to_dense_1d()[0],
            lambda Aj: j_spmv_arrays(Aj.indptr, Aj.indices, Aj.values,
                                     jnp.linspace(-1, 1, Aj.ncols,
                                                  dtype=jnp.float32),
                                     Aj.nrows)),
}


@pytest.mark.parametrize("call", sorted(CALLS))
def test_second_call_finds_its_plan(xla_path, call):
    """The second planned call on a graph builds no plan, looks one up,
    and gives the first call's bits, which match the JAX package."""
    port, jax = CALLS[call]
    S = _csr("float")
    Aj, A = pair(S)
    first, c1 = _traced(lambda: port(A))
    again, c2 = _traced(lambda: port(A))
    assert c1["spmv_plan.builds"] == 1
    assert "spmv_plan.builds" not in c2 and c2["spmv_plan.lookups"] >= 1
    assert GT.same_bits(first, again)
    want = np.asarray(jax(Aj))
    if call in ("sssp", "bfs"):
        np.testing.assert_array_equal(first.numpy(), want)
    else:       # summation order: 1e-5 of max|y|
        assert np.abs(first.numpy() - want).max() <= \
            1e-5 * np.abs(want).max()


def test_entry_goes_with_its_graph():
    """A graph's plans (kept on its flip by column) leave the cache when
    the graph is freed."""
    A = gt.Matrix.from_scipy(_csr("float"))
    AL.sssp(A, 0, optimize=True)
    AL.pagerank_fused(A, max_iter=3, optimize=True)
    assert len(SPRT._plans) > 0
    del A
    gc.collect()
    assert len(SPRT._plans) == 0


@pytest.mark.parametrize("weights", ["int32", "iso"])
def test_write_to_weights_voids_the_plan(xla_path, weights):
    """A graph stored by column, planned, then its weights tripled in
    place: sssp answers as on a fresh graph with the tripled weights (the
    JAX package's and scipy's distances), not with the old plan's."""
    S, iso = _csr(weights), weights == "iso"
    S3 = S * 3
    A = _by_col(S, iso)
    assert A.iso == iso and A.values.dtype == torch.int32
    before = AL.sssp(A, 0, optimize=True)
    A.values.mul_(3)
    after = AL.sssp(A, 0)
    fresh = AL.sssp(_by_col(S3, iso), 0, optimize=True)
    S3 = S3.astype(np.float64)
    want = np.asarray(jalg.graph.sssp(pair(S3)[0], 0))
    assert GT.same_bits(after, fresh)
    np.testing.assert_array_equal(after.numpy(), want)
    np.testing.assert_array_equal(after.numpy(), csg.dijkstra(S3, indices=0))
    assert not GT.same_bits(after, before)


def test_other_values_reuse_the_tiling():
    """An fp32 plan, then the fp64 values of the same arrays: one build,
    both plans on one tiling, each bound to its own values."""
    S = _csr("float")
    ip, ix = (torch.from_numpy(a.astype(np.int32)) for a in (S.indptr,
                                                              S.indices))
    v32 = torch.from_numpy(S.data)
    v64 = v32.double()

    def plans():
        return (SPRT.plan_for(ip, ix, v32, S.shape),
                SPRT.plan_for(ip, ix, v64, S.shape))
    (p32, p64), c = _traced(plans)
    assert c["spmv_plan.builds"] == 1 and c["spmv_plan.lookups"] == 2
    assert p32.values is v32 and p64.values is v64
    assert torch.equal(p32.tile_row, p64.tile_row)
    x = torch.linspace(-1, 1, S.shape[1], dtype=torch.float64)
    np.testing.assert_allclose(SPRT.spmv_route_ds(x, p64).numpy(),
                               S.astype(np.float64) @ x.numpy(), rtol=1e-12)
