"""Port parity: sparse x sparse mxm (the SELL engine on the plain versions
of the sort-reduce kernels, and the classic ESC path), masked SpGEMM,
empty operands and the vxm 1-row SpGEMM (graphblas_tpu_torch against
graphblas_tpu and scipy).

The JAX side runs on its XLA path (classic ESC, ``xla_path``); the cases
against its SELL engine with the Pallas kernels in interpret mode are in
test_torch_spgemm_interpret.py; select, the fused mxm + reduce and
triangle counting in test_torch_triangles.py.  Tolerances:
exact for int, bool, min/max and PAIR counts; 1e-5*max|c| for fp32
plus-times (summation order differs).  Heavy rows (the classic fallback
inside SELL) and the wide keys (n = 2^23 columns) are in
test_torch_spgemm_layout.py."""

import numpy as np
import pytest
import scipy.sparse as sps

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.core import monoid as TM
from graphblas_tpu_torch.core import ops as TO
from graphblas_tpu_torch.core import semiring as TS
from torch_parity import (assert_same, cpu_default, pair,  # noqa: F401
                          sparse_operand, to_port, xla_path)

N = 80
FP32_TOL = 1e-5


SEMIRINGS = {  # name: (operand kind, tolerance)
    "PLUS_TIMES": ("f32", FP32_TOL), "MIN_PLUS": ("i32", None),
    "PLUS_PAIR": ("i64", None), "LOR_LAND": ("bool", None)}
MASKS = {  # name: (mask kind, Descriptor kwargs)
    "none": (None, {}), "structural": ("pattern", dict(mask_structure=True)),
    "valued": ("values", {}),
    "complement": ("pattern", dict(mask_structure=True,
                                   mask_complement=True))}


def _mask(rng, kind):
    """A sparse mask; ``values`` holds explicit zeros."""
    S = sparse_operand(rng, N, N, 0.15, "f32")
    if kind == "values":
        S.data = (rng.random(S.nnz) < 0.6).astype(np.float32)
    return pair(S)


def _dense_ref(S, T, srname):
    a = S.toarray().astype(np.float64)
    b = T.toarray().astype(np.float64)
    pa, pb = S.toarray() != 0, T.toarray() != 0
    if srname == "PLUS_TIMES":
        return a @ b, (pa.astype(int) @ pb.astype(int)) > 0


@pytest.mark.parametrize("srname,mask", [
    ("PLUS_TIMES", "none"), ("PLUS_TIMES", "valued"),
    ("PLUS_TIMES", "complement"), ("MIN_PLUS", "structural"),
    ("MIN_PLUS", "complement"), ("PLUS_PAIR", "valued"),
    ("LOR_LAND", "none"), ("LOR_LAND", "structural")])
def test_mxm_matches(xla_path, srname, mask):
    """SELL (plain kernels) and classic against the JAX classic path;
    plus-times also against scipy."""
    kind, tol = SEMIRINGS[srname]
    rng = np.random.default_rng(len(srname) * 7 + len(mask))
    S = sparse_operand(rng, N, N, 0.08, kind)
    T2 = sparse_operand(rng, N, N, 0.08, kind)
    (Aj, At), (Bj, Bt) = pair(S), pair(T2)
    mkind, dkw = MASKS[mask]
    kw_j, kw_t = {}, {}
    if mkind is not None:
        kw_j["mask"], kw_t["mask"] = _mask(rng, mkind)
        kw_j["desc"], kw_t["desc"] = gb.Descriptor(**dkw), \
            gt.Descriptor(**dkw)
    Rj = gb.mxm(Aj, Bj, getattr(gb.semiring, srname), **kw_j)
    Rt = gt.mxm(At, Bt, getattr(TS, srname), **kw_t)
    assert Rj.dtype.name == Rt.dtype.name
    assert_same(Rj, Rt, scale_tol=tol)
    gt.set_option("kernels_enabled", False)
    try:
        assert_same(Rj, gt.mxm(At, Bt, getattr(TS, srname), **kw_t),
                    scale_tol=tol)
    finally:
        gt.set_option("kernels_enabled", True)
    if srname == "PLUS_TIMES" and mask == "none":
        want, pres = _dense_ref(S, T2, srname)
        v, p = (x.numpy() for x in Rt.to_dense_pair())
        np.testing.assert_array_equal(p, pres)
        assert np.abs(v - want).max() <= FP32_TOL * np.abs(want).max()


def test_empty_operands(xla_path):
    rng = np.random.default_rng(23)
    S = sparse_operand(rng, N, N, 0.08, "f32")
    Z = sps.csr_matrix((N, N), dtype=np.float32)
    rows_only = sps.csr_matrix(S.toarray() * (np.arange(N) < 10)[:, None])
    hits_empty = sps.csr_matrix(S.toarray() * (np.arange(N) >= 10)[None, :])
    for a, b in ((S, Z), (Z, S), (hits_empty, rows_only)):
        (Aj, At), (Bj, Bt) = pair(a), pair(b)
        Rt = gt.mxm(At, Bt, TS.PLUS_TIMES)
        assert Rt.nvals == 0
        assert_same(gb.mxm(Aj, Bj, gb.semiring.PLUS_TIMES), Rt)


@pytest.mark.parametrize("srname", ["LXOR_LAND", "TIMES_PLUS"])
def test_vxm_one_row_spgemm(xla_path, srname):
    """vxm with a sparse u and a monoid the SpMSpV scatter declines runs
    a 1-row SpGEMM over A's rows."""
    rng = np.random.default_rng(25)
    kind = "bool" if srname == "LXOR_LAND" else "f32"
    S = sparse_operand(rng, N, N, 0.1, kind)
    if kind == "f32":
        S.data = rng.integers(1, 3, S.nnz).astype(np.float32)
    Aj, At = pair(S)
    idx = np.flatnonzero(rng.random(N) < 0.3)
    vals = np.ones(idx.size, np.bool_) if kind == "bool" else \
        rng.integers(1, 3, idx.size).astype(np.float32)
    uj = gb.Vector.from_coo(idx, vals, N)
    ut = to_port(uj)
    if srname == "LXOR_LAND":
        srj, srt = gb.semiring.LXOR_LAND, TS.LXOR_LAND
    else:
        from graphblas_tpu.core import monoid as JM
        from graphblas_tpu.core import ops as JO
        srj = gb.semiring.Semiring(JM.TIMES, JO.PLUS, "TIMES_PLUS")
        srt = gt.make_semiring(TM.TIMES, TO.PLUS, "TIMES_PLUS")
    Rt = gt.vxm(ut, At, srt)
    assert isinstance(Rt, gt.Vector)
    assert_same(gb.vxm(uj, Aj, srj), Rt)


def test_prep_cache_follows_operand_values():
    """The SELL prep is cached per operand tensors: new values over a
    shared pattern (apply) and a fresh mask each time must never reuse a
    table built from freed tensors."""
    rng = np.random.default_rng(29)
    S = sparse_operand(rng, N, N, 0.08, "i32")
    X = sparse_operand(rng, N, N, 0.08, "i32")
    A, Xt = gt.Matrix.from_scipy(S), gt.Matrix.from_scipy(X)
    for k in range(1, 7):
        B = gt.apply(A, TO.TIMES, bind=("second", k))
        assert B.indptr is A.indptr
        got = gt.mxm(B, Xt, TS.PLUS_TIMES).to_scipy()
        assert abs(got - (S * k) @ X).max() == 0
        Ms = sparse_operand(rng, N, N, 0.1, "f32")
        M = gt.Matrix.from_scipy(Ms)
        got = gt.mxm(A, Xt, TS.PLUS_TIMES, mask=M,
                     desc=gt.Descriptor(mask_structure=True)).to_scipy()
        want = (S @ X).multiply(Ms != 0)
        assert abs(got - want).max() == 0 and got.nnz == want.count_nonzero()
        del B, M                # the next ones may take the freed ids
    from graphblas_tpu_torch.ops import spgemm_sell as SGS
    assert len(SGS._prep_cache) == 0     # entries go with their operands
    gt.mxm(A, Xt, TS.PLUS_TIMES)
    assert len(SGS._prep_cache) == 1
    del A, Xt
    assert len(SGS._prep_cache) == 0     # entries go with their operands


@pytest.mark.parametrize("srname,dtype", [
    ("MAX_TIMES", np.int8), ("MIN_PLUS", np.int8), ("MAX_PLUS", np.uint8)])
def test_narrow_int_products_wrap(srname, dtype):
    """Products that overflow a narrow type reduce as wrapped values under
    MIN/MAX, in SELL and in the classic path alike."""
    rng = np.random.default_rng(31)
    lo = 0 if dtype == np.uint8 else -100
    dense = []
    for _ in range(2):
        d = rng.integers(lo, 120, (30, 30)) * (rng.random((30, 30)) < 0.3)
        dense.append(d)
    a, b = dense
    S = sps.csr_matrix(a.astype(dtype))
    T2 = sps.csr_matrix(b.astype(dtype))
    mul = np.multiply if srname.endswith("TIMES") else np.add
    prod = mul(a[:, :, None], b[None, :, :]).astype(dtype)   # wraps
    pres = (a != 0)[:, :, None] & (b != 0)[None, :, :]
    red = np.max if srname.startswith("MAX") else np.min
    fill = np.iinfo(dtype).min if red is np.max else np.iinfo(dtype).max
    want = red(np.where(pres, prod, fill), axis=1)
    want_p = pres.any(axis=1)
    sr = getattr(TS, srname)
    for kernels in (True, False):
        gt.set_option("kernels_enabled", kernels)
        try:
            R = gt.mxm(gt.Matrix.from_scipy(S), gt.Matrix.from_scipy(T2), sr)
        finally:
            gt.set_option("kernels_enabled", True)
        v, p = (x.numpy() for x in R.to_dense_pair())
        assert R.dtype.np_dtype == np.dtype(dtype)
        np.testing.assert_array_equal(p, want_p)
        np.testing.assert_array_equal(v[p], want[want_p])
