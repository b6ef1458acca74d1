"""Port parity against the JAX package's fast SpGEMM tier
(``GB_SPGEMM_TIER=v1``) with its Pallas sort-reduce kernels in interpret
mode, the JAX package's own CPU route for them (at most 2^20 products).
The port runs its fast tier on the kernels' plain versions (the SELL
engine's slot-domain limit lowered, so SELL declines).  Plain, masked
and complemented products on a small skewed matrix (classes up to 512); the case that reaches the C = 32768 class
runs a 32768-slot Pallas sort in interpret mode (~30 s) and is marked
slow.  Tolerance 1e-5*max|c| for fp32 plus-times (summation order)."""

import numpy as np
import pytest
import scipy.sparse as sps

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.core import semiring as TS
from graphblas_tpu_torch.ops import spgemm_sell as SGS
from test_torch_spgemm_fast import skewed
from torch_parity import assert_same, cpu_default, pair  # noqa: F401

FP32_TOL = 1e-5


@pytest.fixture
def fast_tiers(monkeypatch):
    """Both packages on their fast tier, JAX's Pallas kernels on (in
    interpret mode on the CPU); JAX's burble lines are returned."""
    monkeypatch.setenv("GB_SPGEMM_TIER", "v1")
    monkeypatch.setattr(SGS, "MAX_SLOTS", 1)
    msgs = []
    old = {k: gb.get_option(k) for k in ("pallas_enabled", "burble",
                                          "printf")}
    gb.set_option("pallas_enabled", True)
    gb.set_option("printf", msgs.append)
    gb.set_option("burble", True)
    yield msgs
    for k, v in old.items():
        gb.set_option(k, v)


def small_skewed(rng, n=120):
    lens = rng.zipf(1.6, n).clip(0, 12)
    rows = np.repeat(np.arange(n), lens)
    S = sps.csr_matrix((rng.standard_normal(rows.size).astype(np.float32),
                        (rows, rng.integers(0, n, rows.size))),
                       shape=(n, n))
    S.sum_duplicates()
    return S


CASES = ["plain", "masked", "complement",
         pytest.param("class_32768", marks=pytest.mark.slow)]


@pytest.mark.parametrize("case", CASES)
def test_fast_tier_matches_jax_interpret(fast_tiers, case):
    rng = np.random.default_rng(37)
    S = skewed("f32") if case == "class_32768" else small_skewed(rng)
    n = S.shape[0]
    (Aj, At) = pair(S)
    kw_j, kw_t = {}, {}
    if case in ("masked", "complement"):
        M = (sps.random(n, n, density=0.2, format="csr", random_state=3)
             != 0).astype(np.float32)
        d = dict(mask_structure=True, mask_complement=case == "complement")
        kw_j["mask"], kw_t["mask"] = pair(M)
        kw_j["desc"], kw_t["desc"] = gb.Descriptor(**d), gt.Descriptor(**d)
    Rj = gb.mxm(Aj, Aj, gb.semiring.PLUS_TIMES, **kw_j)
    assert any("fast sort-reduce tier" in m for m in fast_tiers)
    assert_same(Rj, gt.mxm(At, At, TS.PLUS_TIMES, **kw_t),
                scale_tol=FP32_TOL)
