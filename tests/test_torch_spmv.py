"""Port parity: the SpMV kernels' wrappers, plain versions and plans
(graphblas_tpu_torch.kernels.spmv_onehot / spmv_route).

On the CPU every wrapper runs its kernel's plain torch version;
tests/test_torch_cuda.py holds the CUDA kernels against those plain
versions on a card."""

import dataclasses
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
        bound = rel * float(np.abs(want).max(initial=0.0))
        assert float(np.abs(got - want).max(initial=0.0)) <= bound
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


TILE = SPR._cuda.SPMV_TILE
TILING_CASES = {
    "skewed": None,
    "m0": [],
    "nnz0": [0] * 5000,
    "empty_rows_then_hub": [0] * 3000 + [4000] + [0] * 100,
    "one_row_1e5": [100_000],
    "tile_ends_at_row_end": [TILE - 1, 3, 0, 5],
}


def _degree_csr(deg, rng, n=300, dtype=np.float32):
    """A CSR matrix with exactly these row lengths (columns may repeat)."""
    ip = np.concatenate([[0], np.cumsum(np.asarray(deg, np.int64))])
    nnz = int(ip[-1])
    return sps.csr_matrix((rng.standard_normal(nnz).astype(dtype),
                           rng.integers(0, n, nnz), ip),
                          shape=(len(deg), n))


@pytest.mark.parametrize("case", sorted(TILING_CASES))
def test_plan_tiles_cover_walk(case):
    """The tiles chain along the merge path: each nonzero is taken and
    each row ended by exactly one tile, the one holding its step; the
    plain version over them matches the reference."""
    rng = np.random.default_rng(8)
    deg = TILING_CASES[case]
    S = _skewed_csr(rng) if deg is None else _degree_csr(deg, rng)
    ip, ix, v = _csr_t(S)
    p = SPR.build_plan(ip, ix, v, S.shape)
    m, nnz = S.shape[0], S.nnz
    tr = p.tile_row.numpy().astype(np.int64)
    assert p.nnz == nnz
    assert p.ntiles == -(-(m + nnz) // TILE) and tr[0] == 0 and tr[-1] == m
    yk = np.minimum(np.arange(p.ntiles + 1) * TILE, m + nnz) - tr
    assert yk[0] == 0 and yk[-1] == nnz
    assert (np.diff(tr) >= 0).all() and (np.diff(yk) >= 0).all()
    ipl = S.indptr.astype(np.int64)          # each cut lies on the walk
    assert (ipl[tr] <= yk).all()
    inner = tr < m
    assert (yk[inner] <= ipl[tr[inner] + 1]).all()
    np.testing.assert_array_equal(             # row r ends in its step's tile
        np.searchsorted(tr, np.arange(m), "right") - 1,
        (ipl[1:] + np.arange(m)) // TILE)
    x = rng.standard_normal(S.shape[1]).astype(np.float32)
    xt = torch.from_numpy(x)
    got = SPR.spmv_route(xt, p).numpy()
    _check(got, _reference(S.astype(np.float64), x.astype(np.float64),
                           "plus", "times"), "plus", 1e-5)
    got = SPR.spmv_route_monoid(xt, p, add="min", mul="times").numpy()
    _check(got, _reference(S, x, "min", "times"), "min", 0)


def test_broken_tiling_shows_in_result():
    """The plain version walks the tiles it is given: a tiling that stops
    short leaves its rows NaN, and a cut moved off the walk moves a
    product into the wrong row."""
    rng = np.random.default_rng(9)
    S = _degree_csr([900, 700, 3, 0, 2500, 1, 5], rng)
    ip, ix, v = _csr_t(S)
    x = torch.from_numpy(rng.standard_normal(S.shape[1]).astype(np.float32))
    p = SPR.build_plan(ip, ix, v, S.shape)
    good = SPR.spmv_route(x, p)
    assert not torch.isnan(good).any()
    short = p.tile_row.clone()
    short[-1] = S.shape[0] - 2
    y = SPR.spmv_route(x, dataclasses.replace(p, tile_row=short))
    assert torch.isnan(y[-2:]).all() and torch.equal(y[:-3], good[:-3])
    moved = p.tile_row.clone()
    assert moved[1] == 4                 # the cut inside row 4 ...
    moved[1] = 3                         # ... moved back to row 3's end
    y = SPR.spmv_route(x, dataclasses.replace(p, tile_row=moved))
    assert not torch.allclose(y, good)


@pytest.mark.parametrize("add,mul", [(a, m) for a in ADDS for m in MULS]
                         + [("plus", "fp64")])
def test_planned_plain_matches_unplanned(add, mul):
    """Every instantiation's plain version (15 fp32 semirings, fp64
    plus-times) walks a plan whose 3000-nonzero row is cut between tiles
    and matches the unplanned product."""
    rng = np.random.default_rng(2)
    dt = np.float64 if mul == "fp64" else np.float32
    deg = rng.integers(0, 6, 300)
    deg[::17] = 0
    deg[[5, 40]] = (3000, 700)
    S = _degree_csr(deg, rng, n=250, dtype=dt)
    x = rng.standard_normal(S.shape[1]).astype(dt)
    ip, ix, v = _csr_t(S)
    p = SPR.build_plan(ip, ix, v, S.shape)
    assert p.ntiles > 1 and (p.tile_row[1:-1].numpy() == 5).any()
    if mul == "fp64":
        got, mul = SPR.spmv_route_ds(torch.from_numpy(x), p), "times"
    elif (add, mul) == ("plus", "times"):
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
    merge path; kernels off -> plain torch.  All agree to 1e-5*max|y|."""
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
def test_cut_rows_fold_in_tile_order(add):
    """Hub rows cut across many tiles (the longest 8 times) fold their
    carries in tile order: the same result as a per-row numpy reduce, and
    the same bits on every call."""
    rng = np.random.default_rng(41)
    deg = rng.integers(0, 5, 200)
    deg[[3, 50, 51, 199]] = (9000, 20000, 40, 13333)     # 4 hubs, 1 short
    rows = np.repeat(np.arange(200), deg)
    S = sps.csr_matrix((rng.standard_normal(rows.size).astype(np.float32),
                        (rows, rng.integers(0, 50_000, rows.size))),
                       shape=(200, 50_000))
    S.sum_duplicates()
    ip, ix, v = _csr_t(S)
    p = SPR.build_plan(ip, ix, v, S.shape)
    cut = p.tile_row[1:-1].numpy()                  # rows open at tile ends
    assert np.bincount(cut).max() >= 8 and set(cut) >= {3, 50, 199}
    x = torch.from_numpy(rng.standard_normal(50_000).astype(np.float32))
    y = SPR.spmv_route_monoid(x, p, add=add, mul="times")
    assert torch.equal(y, SPR.spmv_route_monoid(x, p, add=add, mul="times"))
    prod = S.multiply(x.numpy()[None, :]).tocsr()
    ufunc = {"plus": np.add, "min": np.minimum, "max": np.maximum}[add]
    ref = np.array([ufunc.reduce(prod.data[a:b].astype(np.float64))
                    if b > a else SPR.MONOID_IDENTITY[add]
                    for a, b in zip(prod.indptr[:-1], prod.indptr[1:])])
    if add == "plus":
        assert np.abs(y.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    else:
        np.testing.assert_array_equal(y.numpy(), ref.astype(np.float32))


def test_load_plan_refuses_v1_plan(tmp_path):
    """A plan of the port's earlier format (sub-rows in row blocks) is
    refused with a message naming it, not run through the new kernels."""
    path = str(tmp_path / "v1.npz")
    np.savez(path, format=np.array("graphblas_tpu_torch.spmv_plan.v1"),
             shape=np.array([4, 4, 4, 4, 512]), sub_start=np.zeros(4),
             sub_end=np.zeros(4), block_ptr=np.array([0, 4]),
             extra_owner=np.zeros(0), indptr_digest=np.array("x"))
    with pytest.raises(TE.InvalidValue, match="spmv_plan.v1"):
        SPR.load_plan(path)


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
    assert p1.nnz == p0.nnz
    assert torch.equal(p0.tile_row, p1.tile_row)
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
