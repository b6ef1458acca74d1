"""Port parity against the JAX package's SELL SpGEMM engine with its
Pallas sort-reduce kernels in interpret mode (the JAX package's own CPU
route for them; at most 2^20 products): K5 unmasked, K6 masked and
complemented, K8 wide keys (K7, triangle counting, is in
test_torch_triangles.py).  The port runs its SELL
engine on the kernels' plain versions.  Tolerance 1e-5*max|c| for fp32
plus-times (summation order), exact counts."""

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.core import semiring as TS
from torch_parity import (assert_same, cpu_default, pair,  # noqa: F401
                          sparse_operand, wide_operands)

N = 80
FP32_TOL = 1e-5


@pytest.fixture
def sell_interpret():
    """The JAX side on its SELL engine (Pallas kernels in interpret mode
    on the CPU, for products of at most 2^20)."""
    old = gb.get_option("pallas_enabled")
    gb.set_option("pallas_enabled", True)
    yield
    gb.set_option("pallas_enabled", old)


INTERP_CASES = ["plain", "masked", "complement",
                pytest.param("wide_masked", marks=pytest.mark.slow)]


@pytest.mark.parametrize("case", INTERP_CASES)
def test_mxm_matches_jax_sell_interpret(sell_interpret, case):
    """Against the JAX SELL engine with its Pallas kernels in interpret
    mode (K5 unmasked, K6 masked/complemented, K8 wide keys)."""
    rng = np.random.default_rng(31 + len(case))
    if case == "wide_masked":
        A, B, Mk = wide_operands(rng, True)
        desc = {}
    else:
        A, B = sparse_operand(rng, N, N, 0.08, "f32"), sparse_operand(rng, N, N, 0.08, "f32")
        Mk = sparse_operand(rng, N, N, 0.2, "f32") if case != "plain" else None
        desc = dict(mask_structure=True,
                    mask_complement=case == "complement")
    (Aj, At), (Bj, Bt) = pair(A), pair(B)
    kw_j, kw_t = {}, {}
    if Mk is not None:
        kw_j["mask"], kw_t["mask"] = pair(Mk)
        kw_j["desc"], kw_t["desc"] = gb.Descriptor(**desc), \
            gt.Descriptor(**desc)
    assert_same(gb.mxm(Aj, Bj, gb.semiring.PLUS_TIMES, **kw_j),
                gt.mxm(At, Bt, TS.PLUS_TIMES, **kw_t), scale_tol=FP32_TOL)
