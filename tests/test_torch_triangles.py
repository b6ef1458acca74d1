"""Port parity: select(TRIL), the fused mxm + reduce (mxm_reduce_scalar),
triangle counting and the SELL engine's host layout sweep and running
max (graphblas_tpu_torch against
graphblas_tpu and scipy).  The JAX side runs on its XLA path, and once on
its SELL engine with the Pallas kernels in interpret mode (K7, the masked
PAIR counter).  Counts and int sums are exact."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.algorithms import graph as JG
from graphblas_tpu.utils import native as JNAT
from graphblas_tpu_torch.core import ops as TO
from graphblas_tpu_torch.core import semiring as TS
from graphblas_tpu_torch.ops import spgemm_sell as SGS
from graphblas_tpu_torch.utils import native as TNAT
from torch_parity import (assert_same, cpu_default, pair,  # noqa: F401
                          sparse_operand, tc_graph, tc_scipy, xla_path)

N = 80


@pytest.fixture
def sell_interpret():
    """The JAX side on its SELL engine (Pallas kernels in interpret mode
    on the CPU)."""
    old = gb.get_option("pallas_enabled")
    gb.set_option("pallas_enabled", True)
    yield
    gb.set_option("pallas_enabled", old)


def test_triangle_count_matches(xla_path):
    """Fused SELL count (K7 plain version) and the classic mxm + reduce
    against the JAX package and scipy; bool input takes K6 + reduce."""
    rng = np.random.default_rng(33)
    S = tc_graph(rng)
    want = tc_scipy(S)
    assert want > 0
    Aj, At = pair(S)
    assert JG.triangle_count(Aj) == want
    assert gt.triangle_count(At) == want
    assert gt.triangle_count(At) == want                  # cached L, L'
    assert gt.triangle_count(pair(S.astype(bool))[1]) == want
    gt.set_option("kernels_enabled", False)
    try:
        assert gt.triangle_count(pair(S)[1]) == want
    finally:
        gt.set_option("kernels_enabled", True)


def test_triangle_count_matches_jax_sell_interpret(sell_interpret):
    rng = np.random.default_rng(35)
    S = tc_graph(rng, n=150)
    Aj, At = pair(S)
    assert gt.triangle_count(At) == JG.triangle_count(Aj) == tc_scipy(S)


def test_mxm_reduce_scalar_matches(xla_path):
    rng = np.random.default_rng(37)
    S = sparse_operand(rng, N, N, 0.1, "i32")
    M = sparse_operand(rng, N, N, 0.3, "f32")
    (Aj, At), (Mj, Mt) = pair(S), pair(M)
    d = gt.Descriptor(mask_structure=True)
    got = gt.mxm_reduce_scalar(At, At, TS.PLUS_TIMES, mask=Mt, desc=d)
    C = gb.mxm(Aj, Aj, gb.semiring.PLUS_TIMES, mask=Mj,
               desc=gb.Descriptor(mask_structure=True))
    assert int(got) == int(np.asarray(C.values).astype(np.int64).sum())
    # floats are not an exact sum: the fused path declines
    F = pair(sparse_operand(rng, N, N, 0.1, "f32"))[1]
    assert gt.mxm_reduce_scalar(F, F, TS.PLUS_TIMES) is None


@pytest.mark.parametrize("fmt", ["sparse", "bitmap"])
def test_select_tril_matches(xla_path, fmt):
    rng = np.random.default_rng(39)
    S = sparse_operand(rng, N, N + 7, 0.1, "f32")
    Aj, At = pair(S)
    if fmt == "bitmap":
        Aj, At = Aj.to_format(gb.BITMAP), At.to_format(gt.BITMAP)
    for k in (-1, 0, 3):
        Rj = gb.select(Aj, gb.operators.TRIL, k)
        Rt = gt.select(At, TO.TRIL, k)
        assert_same(Rj, Rt)
        np.testing.assert_array_equal(
            Rt.to_scipy().toarray(), sps.tril(S, k).toarray())


def test_layout_sweep_matches():
    """The port's Python sweep (and its native one) against the JAX
    package's sweep on random rows, with and without tokens."""
    rng = np.random.default_rng(41)
    for trial in range(6):
        m = int(rng.integers(1, 4000))
        rn = rng.integers(0, 300, m) * (rng.random(m) < 0.7)
        ne = rng.integers(0, 20, m)
        rt = (rng.random(m) < 0.5).astype(np.uint8) if trial % 2 else None
        args = (rn, ne, rt, 256, 1 << 13, 1 << 13, 1 << 10)
        want = JNAT.spgemm_layout(*args)
        for got in (TNAT.spgemm_layout_plain(*args),
                    TNAT.spgemm_layout(*args)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_sell_eligibility_by_predicate():
    """SELL runs only where a sort-reduce kernel exists; any other monoid
    or type goes to the classic path (no exception-driven fallback)."""
    assert SGS.ineligible(TS.PLUS_TIMES, gt.types.FP32, 100) is None
    assert SGS.ineligible(TS.LOR_LAND, gt.types.BOOL, 100) is None
    assert SGS.ineligible(TS.PLUS_PAIR, gt.types.INT64, 100) is None
    assert "ANY" in SGS.ineligible(TS.ANY_PAIR, gt.types.FP32, 100)
    assert "FP64" in SGS.ineligible(TS.PLUS_TIMES, gt.types.FP64, 100)
    assert "positional" in SGS.ineligible(TS.MIN_SECONDI, gt.types.INT64,
                                          100)


@pytest.mark.parametrize("n", [1, 1000, 1024, 5000, 1 << 21])
def test_chunked_cummax_matches_torch(n):
    """The SELL engine's running max (rows of 1024 scanned in parallel,
    then carried) equals torch.cummax, across chunk edges and two levels
    of carry."""
    x = torch.from_numpy(np.random.default_rng(n).integers(
        -(1 << 40), 1 << 40, n))
    assert torch.equal(SGS._cummax(x), torch.cummax(x, 0).values)
