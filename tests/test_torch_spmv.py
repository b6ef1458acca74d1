"""Port parity: the SpMV kernels' wrappers, plain versions and plans
(graphblas_tpu_torch.kernels.spmv_onehot / spmv_route).

On the CPU every wrapper runs its kernel's plain torch version;
tests/test_torch_cuda.py holds the CUDA kernels against those plain
versions on a card."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.kernels import spmv_route as JSPR
from graphblas_tpu.ops.mxm import spmv_arrays as j_spmv_arrays
from graphblas_tpu_torch.core import errors as TE
from graphblas_tpu_torch.kernels import spmv_onehot as OH
from graphblas_tpu_torch.kernels import spmv_route as SPR
from graphblas_tpu_torch.ops.mxm import spmv_arrays as t_spmv_arrays
from torch_parity import cpu_default, random_csr, xla_path  # noqa: F401

ADDS = ("plus", "min", "max")
MULS = ("times", "plus", "first", "second", "pair")


def _skewed_csr(rng, m=300, n=250, dtype=np.float32):
    """Power-law-ish rows: empty rows, a 3000-entry hub row, a few
    medium rows."""
    deg = rng.integers(0, 6, m)
    deg[::17] = 0
    deg[5] = 3000
    deg[40] = 700
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, n, rows.size)
    S = sps.csr_matrix((rng.standard_normal(rows.size).astype(dtype),
                        (rows, cols)), shape=(m, n))
    S.sum_duplicates()
    return S


def _csr_t(S, device="cpu"):
    return (torch.from_numpy(S.indptr.astype(np.int32)).to(device),
            torch.from_numpy(S.indices.astype(np.int32)).to(device),
            torch.from_numpy(S.data.copy()).to(device))


def _reference(S, x, add, mul):
    """Unplanned semiring SpMV in numpy (same IEEE products per entry)."""
    C = S.tocoo()
    a, xv = C.data, x[C.col]
    prod = {"times": xv * a, "plus": xv + a, "first": a, "second": xv,
            "pair": np.ones_like(a)}[mul]
    ident = {"plus": 0.0, "min": np.inf, "max": -np.inf}[add]
    y = np.full(S.shape[0], ident, S.dtype)
    {"plus": np.add, "min": np.minimum, "max": np.maximum}[add].at(
        y, C.row, prod)
    return y


def _check(got, want, add, rel):
    """Exact for min/max (same products, no rounding); rel*max|y| for
    plus (summation order differs)."""
    if add == "plus":
        bound = rel * float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= bound
    else:
        np.testing.assert_array_equal(got, want)


def test_rowwarp_plain_matches_jax_xla(xla_path):
    """K2's plain version vs the JAX package's XLA SpMV; 1e-5*max|y|
    (fp32, different summation order)."""
    rng = np.random.default_rng(0)
    S = _skewed_csr(rng)
    x = rng.standard_normal(S.shape[1]).astype(np.float32)
    want = np.asarray(j_spmv_arrays(jnp.asarray(S.indptr.astype(np.int32)),
                                    jnp.asarray(S.indices.astype(np.int32)),
                                    jnp.asarray(S.data), jnp.asarray(x),
                                    S.shape[0]))
    ip, ix, v = _csr_t(S)
    got = OH.spmv(ip, ix, v, torch.from_numpy(x), S.shape[0]).numpy()
    _check(got, want, "plus", 1e-5)
    assert OH.launches == 0          # CPU tensors never launch


def test_plan_splits_rows_and_balances_blocks():
    rng = np.random.default_rng(1)
    S = _skewed_csr(rng)
    ip, ix, v = _csr_t(S)
    p = SPR.build_plan(ip, ix, v, S.shape, row_cap=32, block_cost=256)
    counts = np.diff(S.indptr)
    assert p.m_sub == S.shape[0] + int(np.maximum(
        -(-counts // 32) - 1, 0).sum())
    assert p.extra_owner is not None and p.nnz == S.nnz
    lens = (p.sub_end - p.sub_start).numpy()
    assert lens.max() <= 32 and lens.sum() == S.nnz
    bp = p.block_ptr.numpy()
    assert bp[0] == 0 and bp[-1] == p.m_sub and (np.diff(bp) > 0).all()
    cost = np.add.reduceat(lens + SPR.ROW_COST, bp[:-1])
    assert cost.max() <= 256 + 32 + SPR.ROW_COST


@pytest.mark.parametrize("add,mul", [(a, m) for a in ADDS for m in MULS])
def test_planned_plain_matches_unplanned(add, mul):
    """Every fp32 instantiation's plain version walks a plan whose rows are
    forced to split (row_cap 16) and matches the unplanned product."""
    rng = np.random.default_rng(2)
    S = _skewed_csr(rng)
    x = rng.standard_normal(S.shape[1]).astype(np.float32)
    ip, ix, v = _csr_t(S)
    p = SPR.build_plan(ip, ix, v, S.shape, row_cap=16, block_cost=64)
    assert p.m_sub > p.m
    if (add, mul) == ("plus", "times"):
        got = SPR.spmv_route(torch.from_numpy(x), p)
        _check(got.numpy(), OH.spmv_plain(ip, ix, v, torch.from_numpy(x),
                                          S.shape[0]).numpy(), add, 1e-5)
    else:
        got = SPR.spmv_route_monoid(torch.from_numpy(x), p, add=add,
                                    mul=mul)
    _check(got.numpy(), _reference(S, x, add, mul), add, 1e-5)
    assert SPR.launches == {"spmv_route": 0, "spmv_route_monoid": 0,
                            "spmv_route_ds": 0}


def test_planned_fp64_matches_jax_xla(xla_path):
    """K4 (fp64) plain version vs the JAX package's fp64 XLA SpMV;
    1e-12*max|y|."""
    rng = np.random.default_rng(3)
    S = _skewed_csr(rng, dtype=np.float64)
    x = rng.standard_normal(S.shape[1])
    want = np.asarray(j_spmv_arrays(jnp.asarray(S.indptr.astype(np.int32)),
                                    jnp.asarray(S.indices.astype(np.int32)),
                                    jnp.asarray(S.data), jnp.asarray(x),
                                    S.shape[0]))
    ip, ix, v = _csr_t(S)
    p = SPR.plan_for(ip, ix, v, S.shape)
    got = t_spmv_arrays(ip, ix, v, torch.from_numpy(x), S.shape[0])
    assert got.dtype == torch.float64
    _check(got.numpy(), want, "plus", 1e-12)
    got2 = SPR.spmv_route_ds(torch.from_numpy(x), p).numpy()
    _check(got2, want, "plus", 1e-12)


def test_spmv_arrays_tiers(xla_path):
    """Tier choice by predicate: plan cached -> planned; no plan ->
    row-warp; kernels off -> plain torch.  All agree to 1e-5*max|y|."""
    rng = np.random.default_rng(4)
    S = _skewed_csr(rng)
    x = torch.from_numpy(rng.standard_normal(S.shape[1]).astype(np.float32))
    ip, ix, v = _csr_t(S)
    m = S.shape[0]
    y_rowwarp = t_spmv_arrays(ip, ix, v, x, m).numpy()
    SPR.plan_for(ip, ix, v, S.shape)
    y_plan = t_spmv_arrays(ip, ix, v, x, m).numpy()
    gt.set_option("kernels_enabled", False)
    try:
        y_torch = t_spmv_arrays(ip, ix, v, x, m).numpy()
    finally:
        gt.set_option("kernels_enabled", True)
    _check(y_plan, y_rowwarp, "plus", 1e-5)
    _check(y_torch, y_rowwarp, "plus", 1e-5)


@pytest.mark.parametrize("add", ADDS)
def test_split_rows_fold_without_atomics(add):
    """Hub rows split into many sub-rows fold through the owner table:
    the same result as the index_add_ / scatter_reduce_ fold it replaced
    and as a per-row numpy reduce, and the same bits on every call."""
    rng = np.random.default_rng(41)
    deg = rng.integers(0, 5, 200)
    deg[[3, 50, 51, 199]] = (900, 2000, 40, 1333)        # 4 hubs, 1 short
    rows = np.repeat(np.arange(200), deg)
    S = sps.csr_matrix((rng.standard_normal(rows.size).astype(np.float32),
                        (rows, rng.integers(0, 5000, rows.size))),
                       shape=(200, 5000))
    S.sum_duplicates()
    ip, ix, v = (torch.from_numpy(a) for a in
                 (S.indptr.astype(np.int32), S.indices.astype(np.int32),
                  S.data))
    p = SPR.build_plan(ip, ix, v, S.shape, row_cap=16, block_cost=64)
    assert p.fold_table.shape[0] == 4 and p.fold_table.shape[1] > 100
    x = torch.from_numpy(rng.standard_normal(5000).astype(np.float32))
    y_sub = SPR.spmv_planned_plain(x, p, add, "times")
    y = SPR._fold_extras(y_sub, p, add)
    assert torch.equal(y, SPR._fold_extras(y_sub, p, add))
    assert torch.equal(y, SPR.spmv_route_monoid(x, p, add=add, mul="times"))
    old = y_sub[:p.m].clone()                 # the atomic fold it replaced
    extra = y_sub[p.m:p.m_sub]
    if add == "plus":
        old.index_add_(0, p.extra_owner, extra)
    else:
        old.scatter_reduce_(0, p.extra_owner, extra,
                            "amin" if add == "min" else "amax")
    prod = S.multiply(x.numpy()[None, :]).tocsr()
    ufunc = {"plus": np.add, "min": np.minimum, "max": np.maximum}[add]
    ref = np.array([ufunc.reduce(prod.data[a:b].astype(np.float64))
                    if b > a else SPR.MONOID_IDENTITY[add]
                    for a, b in zip(prod.indptr[:-1], prod.indptr[1:])])
    if add == "plus":
        tol = 1e-5 * np.abs(ref).max()
        assert np.abs(y.numpy() - ref).max() <= tol
        assert np.abs(y.numpy() - old.numpy()).max() <= tol
    else:
        np.testing.assert_array_equal(y.numpy(), old.numpy())
        np.testing.assert_array_equal(y.numpy(), ref.astype(np.float32))


def test_plan_save_load_and_optimize(tmp_path):
    rng = np.random.default_rng(5)
    S = random_csr(rng, 120, 90, 0.05)
    A = gt.Matrix.from_scipy(S)
    path = str(tmp_path / "plan.npz")
    Ao = A.optimize(plan_path=path)
    p0 = SPR.plan_for(Ao.indptr, Ao.indices, Ao.values, Ao.shape,
                      build=False)
    p1 = SPR.load_plan(path)
    assert p1.values is None and p1.matches(Ao.indptr, Ao.shape)
    for f in ("sub_start", "sub_end", "block_ptr"):
        assert torch.equal(getattr(p0, f), getattr(p1, f))
    # a fresh matrix with the same structure reloads the saved plan
    B = gt.Matrix.from_scipy(S)
    Bo = B.optimize(plan_path=path)
    pb = SPR.plan_for(Bo.indptr, Bo.indices, Bo.values, Bo.shape,
                      build=False)
    assert pb is not None and pb.values is Bo.values
    # a stale plan (other structure) is rebuilt, not used
    S2 = random_csr(np.random.default_rng(6), 120, 90, 0.05)
    C = gt.Matrix.from_scipy(S2).optimize(plan_path=path)
    pc = SPR.plan_for(C.indptr, C.indices, C.values, C.shape, build=False)
    assert pc.matches(C.indptr, C.shape)
    with pytest.raises(TE.InvalidValue):
        p1.bind(C.indptr, C.indices, C.values)


def test_load_plan_refuses_jax_plan(tmp_path):
    rng = np.random.default_rng(7)
    S = random_csr(rng, 60, 60, 0.05)
    jp = JSPR.build_plan(S.indptr, S.indices, S.data, S.shape)
    path = str(tmp_path / "jax_plan.npz")
    JSPR.save_plan(jp, path)
    with pytest.raises(TE.InvalidValue, match="JAX"):
        SPR.load_plan(path)
    legacy = str(tmp_path / "legacy.npz")
    np.savez(legacy, g_hi=np.zeros(3))
    with pytest.raises(TE.InvalidValue, match="JAX"):
        SPR.load_plan(legacy)


def test_empty_and_tiny_matrices():
    for m, n in ((0, 5), (4, 3)):
        ip = torch.zeros(m + 1, dtype=torch.int32)
        ix = torch.zeros(0, dtype=torch.int32)
        v = torch.zeros(0, dtype=torch.float32)
        p = SPR.build_plan(ip, ix, v, (m, n))
        x = torch.ones(n)
        y = SPR.spmv_route_monoid(x, p, add="min", mul="plus")
        assert y.shape == (m,) and bool(torch.isinf(y).all())
        assert SPR.spmv_route(x, p).abs().sum() == 0
        assert OH.spmv(ip, ix, v, x, m).shape == (m,)


def test_identity_constants():
    assert SPR.MONOID_IDENTITY == {"plus": 0.0, "min": math.inf,
                                   "max": -math.inf}
