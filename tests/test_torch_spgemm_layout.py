"""Port parity: sparse x sparse mxm where the SELL engine's slot layout
leaves its common case, against scipy and the JAX package's classic path:
  * rows whose products pass one sort tile (2048 slots) take the classic
    ESC fallback and are merged by row id into the same output;
  * with n = 2^23 columns the sort keys are two planes (rank, column) and
    pass 1 runs the wide sort-reduce kernel K8 (on its plain version
    here); A is short (200 rows), so the host layout sweep stays cheap.
Exact: the values are small integers."""

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.core import semiring as TS
from graphblas_tpu_torch.kernels import sortreduce as SRD
from torch_parity import (assert_same, cpu_default, pair,  # noqa: F401
                          sparse_operand, wide_operands, xla_path)


def _heavy(rng):
    """A with two hub rows whose products pass one sort tile (2048
    slots), so they take the classic fallback inside SELL."""
    S = sparse_operand(rng, 300, 300, 0.03, "i32").tolil()
    for r in (5, 150):
        S[r, rng.choice(300, 250, replace=False)] = 3
    B = sparse_operand(rng, 300, 300, 0.06, "i32")
    return S.tocsr(), B


@pytest.mark.parametrize("masked", [False, True])
def test_heavy_rows_take_the_fallback(xla_path, masked):
    rng = np.random.default_rng(21 + masked)
    S, B = _heavy(rng)
    (Aj, At), (Bj, Bt) = pair(S), pair(B)
    kw_j, kw_t = {}, {}
    M = sparse_operand(rng, 300, 300, 0.2, "f32")
    if masked:
        kw_j["mask"], kw_t["mask"] = pair(M)
    gt.set_option("burble", True)
    msgs = []
    old = gt.get_option("printf")
    gt.set_option("printf", msgs.append)
    try:
        Rt = gt.mxm(At, Bt, TS.PLUS_TIMES, **kw_t)
    finally:
        gt.set_option("burble", False)
        gt.set_option("printf", old)
    assert any("spgemm-sell" in s and " 2 fallback rows" in s
               for s in msgs), msgs
    Rj = gb.mxm(Aj, Bj, gb.semiring.PLUS_TIMES, **kw_j)
    assert_same(Rj, Rt)
    want = (S.astype(np.int64) @ B.astype(np.int64))
    if masked:
        want = want.multiply(M != 0)
    got = Rt.to_scipy()
    assert abs(got - want).max() == 0 and got.nnz == want.count_nonzero()



@pytest.mark.parametrize("masked", [False, True])
def test_wide_keys_match_scipy(xla_path, masked):
    rng = np.random.default_rng(27 + masked)
    A, B, M = wide_operands(rng, masked)
    (Aj, At), (Bj, Bt) = pair(A), pair(B)
    kw = {}
    if masked:
        kw["mask"] = pair(M)[1]
    before = dict(SRD.launches)
    Rt = gt.mxm(At, Bt, TS.PLUS_TIMES, **kw)
    assert SRD.launches == before           # CPU tensors: plain versions
    want = A @ B
    if masked:
        want = want.multiply(M != 0)
    got = Rt.to_scipy()
    assert got.nnz == want.count_nonzero() and abs(got - want).max() == 0
    if not masked:
        Rj = gb.mxm(Aj, Bj, gb.semiring.PLUS_TIMES)
        np.testing.assert_array_equal(Rt.indptr.numpy(),
                                      np.asarray(Rj.indptr))
        np.testing.assert_array_equal(Rt.indices.numpy(),
                                      np.asarray(Rj.indices))
        np.testing.assert_array_equal(Rt.values.numpy(),
                                      np.asarray(Rj.values))
