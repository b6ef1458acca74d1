"""Port parity: the fast SpGEMM tier (graphblas_tpu_torch.ops.spgemm_fast)
on the plain versions of the sort-reduce kernels, against the JAX package
on its XLA path (``xla_path``: the classic ESC path) and scipy.  The port
takes the fast tier where the SELL engine declines a product's slot
domain; the ``fast`` fixture lowers that limit so SELL declines every
product.

The operand is a zipf-skewed 400 x 400 matrix (as the JAX package's
tests/test_spgemm_fast.py) with one row built to land in the C = 8192
class and one in the C = 32768 class; burble shows which classes ran.
Tolerances: 1e-5*max|c| for fp32 plus-times (summation order); exact
for ints, bool, min/max and counts."""

import numpy as np
import pytest
import scipy.sparse as sps

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import testing as GT
from graphblas_tpu_torch.core import semiring as TS
from graphblas_tpu_torch.ops import mxm as TMXM
from graphblas_tpu_torch.ops import spgemm_sell as SGS
from torch_parity import (assert_same, cpu_default, pair,  # noqa: F401
                          tc_scipy, xla_path)

N = 400
FP32_TOL = 1e-5


def skewed(kind, seed=3):
    """Zipf row lengths (clipped at 150), values of ``kind``; row 5's
    products exceed 8192 (class 32768), row 6's 2048 (class 8192)."""
    rng = np.random.default_rng(seed)
    lens = rng.zipf(1.4, N).clip(0, 150)
    rows = np.repeat(np.arange(N), lens)
    cols = rng.integers(0, N, rows.size)
    S = sps.csr_matrix((np.ones(rows.size), (rows, cols)), shape=(N, N))
    S.sum_duplicates()
    rl = np.diff(S.indptr)
    order = [k for k in np.argsort(-rl, kind="stable") if k not in (5, 6)]
    L = S.tolil()
    for r, target in ((5, 9000), (6, 3000)):
        pick = order[:int(np.searchsorted(np.cumsum(rl[order]), target)) + 1]
        L.rows[r], L.data[r] = sorted(pick), [1.0] * len(pick)
    S = L.tocsr()
    if kind == "f32":
        S.data = rng.standard_normal(S.nnz).astype(np.float32)
    elif kind == "i32":
        S.data = (np.arange(S.nnz) % 97 + 1).astype(np.int32)
    elif kind == "bool":
        S.data = np.ones(S.nnz, np.bool_)
    return S


@pytest.fixture
def fast(monkeypatch):
    """SELL declines every product, so the port takes its fast tier;
    burble captured."""
    msgs = []
    monkeypatch.setattr(SGS, "MAX_SLOTS", 1)
    gt.set_option("printf", msgs.append)
    gt.set_option("burble", True)
    yield msgs
    gt.set_option("burble", False)


def classes(msgs):
    """The sort classes the fast tier ran, from burble."""
    return {int(m.split("C=")[1].split(":")[0]) for m in msgs
            if "spgemm-fast: class C=" in m}


def _mask(kind, rng, S):
    if kind == "valued":
        M = (S @ S).tocsr()
        M.data = rng.integers(0, 2, M.nnz).astype(np.float32)  # half zeros
        return M
    return (sps.random(N, N, density=0.05, format="csr", random_state=11)
            != 0).astype(np.float32)


CASES = {  # name: (semiring, operand kind, mask kind, descriptor kwargs)
    "plus_times": ("PLUS_TIMES", "f32", None, {}),
    "structural": ("PLUS_TIMES", "f32", "pattern",
                   dict(mask_structure=True)),
    "complement": ("PLUS_TIMES", "f32", "pattern",
                   dict(mask_structure=True, mask_complement=True)),
    "valued": ("PLUS_TIMES", "f32", "valued", {}),
    "min_first": ("MIN_FIRST", "i32", None, {}),
    "max_second": ("MAX_SECOND", "i32", None, {}),
    "lor_land": ("LOR_LAND", "bool", None, {}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fast_tier_matches(xla_path, fast, case):
    srname, kind, mkind, dkw = CASES[case]
    S = skewed(kind)
    (Aj, At) = pair(S)
    kw_j, kw_t = {}, {}
    if mkind is not None:
        kw_j["mask"], kw_t["mask"] = pair(_mask(mkind,
                                                np.random.default_rng(11), S))
        kw_j["desc"], kw_t["desc"] = gb.Descriptor(**dkw), \
            gt.Descriptor(**dkw)
    Rt = gt.mxm(At, At, getattr(TS, srname), **kw_t)
    assert any("fast sort-reduce tier" in m for m in fast)
    assert {8192, 32768} <= classes(fast), fast
    Rj = gb.mxm(Aj, Aj, getattr(gb.semiring, srname), **kw_j)
    assert Rj.dtype.name == Rt.dtype.name
    assert_same(Rj, Rt, scale_tol=FP32_TOL if kind == "f32" else None)
    if case == "plus_times":
        want = (S.astype(np.float64) @ S.astype(np.float64)).toarray()
        v, p = (x.numpy() for x in Rt.to_dense_pair())
        P = (S != 0).astype(int)
        np.testing.assert_array_equal(p, (P @ P).toarray() > 0)
        assert np.abs(v - want).max() <= FP32_TOL * np.abs(want).max()


def test_fast_tier_triangle_count(fast):
    """PLUS_PAIR into INT64 through triangle_count: SELL declines its
    fused count, so the masked mxm runs on the fast tier (K6 plain) and
    a reduce."""
    S = skewed("f32")
    A = gt.Matrix.from_scipy(S)
    assert gt.triangle_count(A) == tc_scipy(S)
    assert any("SELL declined (slot domain)" in m for m in fast)
    assert any("fast sort-reduce tier" in m for m in fast)
    assert not any("spgemm-sell:" in m and " blocks, " in m for m in fast)


def test_fast_tier_multiblock_and_fallback(xla_path, fast, monkeypatch):
    """A flop block of 2^14 padded slots cuts many row blocks, and a
    dense row of A over a denser B has more than 32768 products: it takes
    the classic fallback inside the fast driver."""
    S = skewed("f32")
    rng = np.random.default_rng(9)
    L = S.tolil()
    L.rows[7], L.data[7] = list(range(N)), list(
        rng.standard_normal(N).astype(np.float32))
    S = L.tocsr().astype(np.float32)
    B = sps.random(N, N, density=0.25, format="csr", random_state=5,
                   dtype=np.float32)
    monkeypatch.setattr(TMXM, "SPGEMM_FLOP_BLOCK", 1 << 14)
    (Aj, At), (Bj, Bt) = pair(S), pair(B)
    Rt = gt.mxm(At, Bt, TS.PLUS_TIMES)
    blocks = [m for m in fast if "row blocks (scan-expand)" in m]
    assert int(blocks[0].split("spgemm-fast: ")[1].split()[0]) > 10
    fb = [m for m in fast if "fallback rows" in m]
    assert fb and not fb[0].split("spgemm-fast: ")[1].startswith("0 ")
    assert_same(gb.mxm(Aj, Bj, gb.semiring.PLUS_TIMES), Rt,
                scale_tol=FP32_TOL)


def test_fast_tier_narrow_int_min_wraps(fast):
    """int8 products that overflow wrap to int8 before the MIN reduce, as
    on the classic path (the JAX tier reduces them unwrapped in int32)."""
    rng = np.random.default_rng(31)
    d = (rng.integers(-100, 120, (60, 60))
         * (rng.random((60, 60)) < 0.4)).astype(np.int8)
    A = gt.Matrix.from_scipy(sps.csr_matrix(d))
    got = gt.mxm(A, A, TS.MIN_TIMES)
    assert any("fast sort-reduce tier" in m for m in fast)
    gt.set_option("kernels_enabled", False)          # the classic path
    try:
        want = gt.mxm(A, A, TS.MIN_TIMES)
    finally:
        gt.set_option("kernels_enabled", True)
    assert any("classic ESC (kernels disabled)" in m for m in fast)
    for a, b in zip(got.to_dense_pair(), want.to_dense_pair()):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    prod = d[:, :, None].astype(np.int64) * d[None, :, :]
    assert (prod.astype(np.int8) != prod).any()     # some products wrap


def test_sell_decline_takes_fast_tier(monkeypatch):
    """The product SELL computes under its own limits runs on SELL; with
    the slot-domain limit lowered below it, SELL declines and the fast
    tier computes it, as in the JAX package."""
    msgs = []
    gt.set_option("printf", msgs.append)
    gt.set_option("burble", True)
    S = skewed("i32")
    try:
        A = gt.Matrix.from_scipy(S)
        R0 = gt.mxm(A, A, TS.PLUS_TIMES).to_scipy()
        assert not any("fast sort-reduce tier" in m for m in msgs)
        monkeypatch.setattr(SGS, "MAX_SLOTS", 1 << 10)
        A = gt.Matrix.from_scipy(S)          # SELL's layout is cached per A
        R = gt.mxm(A, A, TS.PLUS_TIMES).to_scipy()
    finally:
        gt.set_option("burble", False)
    assert any("SELL declined (slot domain)" in m for m in msgs)
    assert any("fast sort-reduce tier" in m for m in msgs)
    S64 = S.astype(np.int64)
    assert abs(R - S64 @ S64).max() == 0
    assert abs(R0 - S64 @ S64).max() == 0


def test_sell_counts_fallback_rows_in_its_slot_domain(monkeypatch):
    """SELL holds every fallback row's classic output at once, so its
    slot-domain limit counts the fallback rows' padded slots: with the
    limit just above its own rows' slots, SELL declines a product whose
    fallback rows (rows 5 and 6) push it over, and the fast tier takes
    it."""
    msgs = []
    gt.set_option("printf", msgs.append)
    gt.set_option("burble", True)
    S = skewed("i32")
    try:
        A = gt.Matrix.from_scipy(S)
        gt.mxm(A, A, TS.PLUS_TIMES)
        line = next(m for m in msgs if "spgemm-sell:" in m
                    and " padded slots, " in m)
        d_pad = int(line.split(" blocks, ")[1].split()[0])
        assert int(line.split(", ")[-1].split()[0]) >= 2   # fallback rows
        monkeypatch.setattr(SGS, "MAX_SLOTS", d_pad + 1)
        del msgs[:]
        A = gt.Matrix.from_scipy(S)          # SELL's layout is cached per A
        R = gt.mxm(A, A, TS.PLUS_TIMES).to_scipy()
    finally:
        gt.set_option("burble", False)
    fb = next(m for m in msgs if "slot domain beyond int32" in m)
    assert int(fb.split("(")[1].split()[0]) > d_pad
    assert any("fast sort-reduce tier" in m for m in msgs)
    S64 = S.astype(np.int64)
    assert abs(R - S64 @ S64).max() == 0


def _csr(coo):
    r, c, v, shape = coo
    S = sps.csr_matrix((v, (r, c)), shape=shape)
    S.sum_duplicates()
    return S


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("C", (128, 32768))
def test_fast_tier_full_row_ends_in_empty_runs(xla_path, fast, C, masked):
    """The last row of class C holds exactly C products and ends in A
    entries whose B rows are empty: their zero-length runs start one
    slot past the class's domain, and are dropped (not written)."""
    Ac, Bc, Mc = GT.full_row_operands(C, np.random.default_rng(C))
    SA, SB = _csr(Ac), _csr(Bc)
    flops = np.diff(SB.indptr)[SA.indices]
    last = flops[SA.indptr[-2]:]
    assert last.sum() == C and last[-1] == 0
    (Aj, At), (Bj, Bt) = pair(SA), pair(SB)
    kw_j, kw_t = {}, {}
    if masked:
        SM = (_csr(Mc) != 0).astype(np.float32)
        assert SM[-1].nnz == 0
        kw_j["mask"], kw_t["mask"] = pair(SM)
        kw_j["desc"] = gb.Descriptor(mask_structure=True)
        kw_t["desc"] = gt.Descriptor(mask_structure=True)
    Rt = gt.mxm(At, Bt, TS.PLUS_TIMES, **kw_t)
    assert C in classes(fast), fast
    assert_same(gb.mxm(Aj, Bj, gb.semiring.PLUS_TIMES, **kw_j), Rt,
                scale_tol=FP32_TOL)
    want = SA.astype(np.float64) @ SB.astype(np.float64)
    if masked:
        want = want.multiply(SM != 0)
    assert abs(Rt.to_scipy() - want).max() <= FP32_TOL * abs(want).max()
