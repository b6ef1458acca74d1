"""Port parity: mxv / vxm / mxm with masks, accum and replace, planned
and unplanned (graphblas_tpu_torch.ops.mxm against graphblas_tpu on its
XLA path)."""

import zlib

import numpy as np
import pytest
import scipy.sparse as sps

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.core import ops as TO
from graphblas_tpu_torch.core import semiring as TS
from torch_parity import (assert_same, cpu_default, pair,  # noqa: F401
                          random_csr, to_port, vec_pair, xla_path)

N = 64
SEMIRINGS = ["PLUS_TIMES", "MIN_PLUS", "MAX_TIMES", "LOR_LAND"]


def _operands(rng, srname):
    """(A pair, u pair, C pair, value-mask pair, sparse-mask pair)."""
    boolean = srname == "LOR_LAND"
    keep = np.ones(N, np.float32)
    keep[[3, 5]] = 0                             # an empty row and column
    S = sps.diags(keep) @ random_csr(rng, N, N, 0.08, np.float32) \
        @ sps.diags(keep)
    S = sps.csr_matrix(S)
    S.eliminate_zeros()
    if boolean:
        S = S.astype(bool)
    x = rng.standard_normal(N).astype(np.float32)
    c = rng.standard_normal(N).astype(np.float32)
    if boolean:
        x, c = x > 0, c > 0
    cp = rng.random(N) < 0.6
    mv = (rng.integers(0, 3, N) > 0).astype(np.float32)   # explicit zeros
    mp = rng.random(N) < 0.7
    A = pair(S)
    u = vec_pair(x)
    C = vec_pair(c, cp)
    Mv = vec_pair(mv, mp)
    idx = np.flatnonzero(rng.random(N) < 0.4)
    Mj = gb.Vector.from_coo(idx, np.ones(idx.size, np.float32), N)
    return A, u, C, Mv, (Mj, to_port(Mj))


CASES = {
    # name: (mask, accum, descriptor kwargs)
    "plain": (None, None, {}),
    "value_mask_accum": ("value", "PLUS", {}),
    "struct_comp_replace": ("sparse", "MIN", dict(mask_structure=True,
                                                  mask_complement=True,
                                                  replace=True)),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("srname", SEMIRINGS)
@pytest.mark.parametrize("op", ["mxv", "vxm", "mxv_planned", "vxm_planned"])
def test_mxv_vxm_matches(xla_path, op, srname, case):
    """Exact for min/max/lor-land; 1e-5*max|y| for fp32 plus-times
    (summation order).  "_planned" runs the port through its plan (the
    planned kernels' plain versions), the JAX side unplanned."""
    rng = np.random.default_rng(zlib.crc32(f"{op}{srname}{case}".encode()))
    (Aj, At), (uj, ut), (Cj, Ct), (Mvj, Mvt), (Msj, Mst) = \
        _operands(rng, srname)
    mask, accum, dkw = CASES[case]
    if op == "vxm_planned":
        At = At.to_format("sparse", "col")
        At.T.optimize()        # plan on A's CSC arrays = A' by row
    elif op == "mxv_planned" and srname != "LOR_LAND":
        At = At.optimize()
    fn = op.split("_")[0]
    kw_j, kw_t = {}, {}
    if mask is not None:
        kw_j["mask"], kw_t["mask"] = (Mvj, Mvt) if mask == "value" \
            else (Msj, Mst)
        kw_j["C"], kw_t["C"] = Cj, Ct
    if accum is not None:
        if srname == "LOR_LAND":
            accum = "LOR"
        kw_j["accum"] = getattr(gb.operators, accum)
        kw_t["accum"] = getattr(TO, accum)
    if dkw:
        kw_j["desc"], kw_t["desc"] = gb.Descriptor(**dkw), \
            gt.Descriptor(**dkw)
    srj, srt = getattr(gb.semiring, srname), getattr(TS, srname)
    if fn == "mxv":
        Rj = gb.mxv(Aj, uj, srj, **kw_j)
        Rt = gt.mxv(At, ut, srt, **kw_t)
    else:
        Rj = gb.vxm(uj, Aj, srj, **kw_j)
        Rt = gt.vxm(ut, At, srt, **kw_t)
    assert isinstance(Rt, gt.Vector)
    assert Rj.dtype.name == Rt.dtype.name
    assert_same(Rj, Rt, scale_tol=1e-5 if srname == "PLUS_TIMES" else None)


def test_vxm_chain_matches(xla_path):
    """Planned chain (dense carrier) vs the JAX eager chain; 1e-5*max|y|
    per step, 3 steps."""
    rng = np.random.default_rng(11)
    S = random_csr(rng, N, N, 0.08, np.float32)
    (Aj, At) = pair(S)
    x = rng.standard_normal(N).astype(np.float32)
    uj, ut = vec_pair(x)
    Yj = gb.vxm_chain(uj, Aj, gb.semiring.PLUS_TIMES, 3)
    Ac = At.to_format("sparse", "col")
    Ac.T.optimize()
    Yt = gt.vxm_chain(ut, Ac, TS.PLUS_TIMES, 3)
    vj, pj = Yj.to_dense_1d()
    vt, _ = Yt.to_dense_1d()
    want = np.where(np.asarray(pj), np.asarray(vj), 0)
    assert np.abs(vt.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    Yt2 = gt.vxm_chain(ut, At, TS.PLUS_TIMES, 3)       # eager, no plan
    assert_same(Yj, Yt2, scale_tol=1e-5)


@pytest.mark.parametrize("srname", ["PLUS_TIMES", "MIN_PLUS", "LOR_LAND"])
def test_spmspv_matches(xla_path, srname):
    """vxm with a sparse u: the dense-accumulator SpMSpV path."""
    rng = np.random.default_rng(12)
    S = random_csr(rng, N, N, 0.08, np.float32)
    if srname == "LOR_LAND":
        S = S.astype(bool)
    Aj, At = pair(S)
    idx = np.flatnonzero(rng.random(N) < 0.2)
    vals = rng.standard_normal(idx.size).astype(np.float32)
    if srname == "LOR_LAND":
        vals = vals > 0
    uj = gb.Vector.from_coo(idx, vals, N)
    ut = to_port(uj)
    srj, srt = getattr(gb.semiring, srname), getattr(TS, srname)
    assert_same(gb.vxm(uj, Aj, srj), gt.vxm(ut, At, srt),
                scale_tol=1e-5 if srname == "PLUS_TIMES" else None)


@pytest.mark.parametrize("srname", ["MIN_FIRSTJ", "MIN_SECONDI"])
def test_positional_semirings_match(xla_path, srname):
    """BFS-parent idiom: vxm MIN_FIRSTJ (and mxv MIN_SECONDI) over a
    bitmap frontier; exact integer results."""
    rng = np.random.default_rng(13)
    S = random_csr(rng, N, N, 0.08, np.float32)
    Aj, At = pair(S)
    f = np.arange(N, dtype=np.int64)
    fp = rng.random(N) < 0.3
    uj, ut = vec_pair(f, fp)
    srj, srt = getattr(gb.semiring, srname), getattr(TS, srname)
    assert_same(gb.vxm(uj, Aj, srj), gt.vxm(ut, At, srt))
    assert_same(gb.mxv(Aj, uj, srj), gt.mxv(At, ut, srt))


@pytest.mark.parametrize("srname", ["PLUS_TIMES", "MIN_PLUS"])
def test_mxm_dense_and_spmm_match(xla_path, srname):
    """dense x dense, sparse x dense (3 columns) and dense x sparse."""
    rng = np.random.default_rng(14)
    S = random_csr(rng, N, N, 0.08, np.float32)
    Aj, At = pair(S)
    F = rng.standard_normal((N, 3)).astype(np.float32)
    Fj, Ft = gb.Matrix.from_dense(F), gt.Matrix.from_dense(F)
    tol = 1e-5 if srname == "PLUS_TIMES" else None
    srj, srt = getattr(gb.semiring, srname), getattr(TS, srname)
    assert_same(gb.mxm(Aj, Fj, srj), gt.mxm(At, Ft, srt), scale_tol=tol)
    Ft_j, Ft_t = gb.Matrix.from_dense(F.T.copy()), \
        gt.Matrix.from_dense(F.T.copy())
    assert_same(gb.mxm(Ft_j, Aj, srj), gt.mxm(Ft_t, At, srt),
                scale_tol=tol)
    D = rng.standard_normal((6, N)).astype(np.float32)
    Dp = rng.random((6, N)) < 0.5
    Dj = gb.Matrix.from_dense_masked(D, Dp)
    Dt = gt.Matrix.from_dense_masked(D, Dp)
    assert_same(gb.mxm(Dj, Fj, srj), gt.mxm(Dt, Ft, srt), scale_tol=tol)


def test_diagonal_scaling_and_spgemm_gate(xla_path):
    """rowscale/colscale with a diagonal operand; a general sparse x
    sparse product passes the gate to the ESC SpGEMM (tests in
    test_torch_spgemm.py) and matches the JAX package."""
    rng = np.random.default_rng(15)
    S = random_csr(rng, N, N, 0.08, np.float32)
    Aj, At = pair(S)
    d = rng.standard_normal(N).astype(np.float32)
    r = np.arange(N)
    Dj = gb.Matrix.from_coo(r, r, d, (N, N))
    Dt = gt.Matrix.from_coo(r, r, d, (N, N))
    sr = gb.semiring.PLUS_TIMES
    assert_same(gb.mxm(Dj, Aj, sr), gt.mxm(Dt, At, TS.PLUS_TIMES))
    assert_same(gb.mxm(Aj, Dj, sr), gt.mxm(At, Dt, TS.PLUS_TIMES))
    assert_same(gb.mxm(Aj, Aj, sr), gt.mxm(At, At, TS.PLUS_TIMES),
                scale_tol=1e-5)
