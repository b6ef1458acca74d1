"""The port's CUDA kernels (SpMV K1-K4, sort-reduce K5-K8) against their
plain torch versions, on a card.

Imports no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips where torch sees no card (a CUDA
kernel has no CPU mode)."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from graphblas_tpu_torch import testing as GT
from graphblas_tpu_torch.core import monoid as TM
from graphblas_tpu_torch.kernels import sortreduce as SRD
from graphblas_tpu_torch.kernels import spmv_onehot as OH
from graphblas_tpu_torch.kernels import spmv_route as SPR

pytestmark = pytest.mark.cuda

ADDS = ("plus", "min", "max")
MULS = ("times", "plus", "first", "second", "pair")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _skewed(rng, dtype, device, m=3000, n=50_000):
    """Empty rows, a 20000-nonzero row, random degrees elsewhere."""
    deg = rng.integers(0, 12, m)
    deg[::17] = 0
    rows = np.concatenate([np.repeat(np.arange(m), deg), np.full(20_000, 5)])
    cols = np.concatenate([rng.integers(0, n, int(deg.sum())),
                           rng.choice(n, 20_000, replace=False)])
    S = sps.csr_matrix((rng.standard_normal(rows.size).astype(dtype),
                        (rows, cols)), shape=(m, n))
    S.sum_duplicates()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    x = t(rng.standard_normal(n).astype(dtype))
    return S, t(S.indptr.astype(np.int32)), t(S.indices.astype(np.int32)), \
        t(S.data), x


def _check(got, want, add, rel):
    """Exact for min/max; rel*max|y| for plus (summation order)."""
    g, w = got.cpu().double().numpy(), want.cpu().double().numpy()
    if add == "plus":
        assert np.abs(g - w).max() <= rel * np.abs(w).max()
    else:
        np.testing.assert_array_equal(g, w)


def test_rowwarp_matches_plain(cuda_device):
    S, ip, ix, v, x = _skewed(np.random.default_rng(0), np.float32,
                              cuda_device)
    before = OH.launches
    got = OH.spmv(ip, ix, v, x, S.shape[0])
    torch.cuda.synchronize()
    assert OH.launches == before + 1
    _check(got, OH.spmv_plain(ip, ix, v, x, S.shape[0]), "plus", 1e-5)


@pytest.mark.parametrize("add,mul", [(a, m) for a in ADDS for m in MULS]
                         + [("plus", "fp64")])
def test_planned_matches_plain(cuda_device, add, mul):
    dt = np.float64 if mul == "fp64" else np.float32
    S, ip, ix, v, x = _skewed(np.random.default_rng(1), dt, cuda_device)
    p = SPR.build_plan(ip, ix, v, S.shape, row_cap=16, block_cost=64)
    if mul == "fp64":
        got, mul = SPR.spmv_route_ds(x, p), "times"
    else:
        got = SPR.spmv_route_monoid(x, p, add=add, mul=mul)
    torch.cuda.synchronize()
    want = SPR._fold_extras(SPR.spmv_planned_plain(x, p, add, mul), p, add)
    _check(got, want, add, 1e-12 if dt == np.float64 else 1e-5)


def test_wrappers_refuse_bad_operands(cuda_device):
    S, ip, ix, v, x = _skewed(np.random.default_rng(2), np.float32,
                              cuda_device)
    with pytest.raises(TypeError):
        OH.spmv(ip, ix, v, x.double(), S.shape[0])
    with pytest.raises(ValueError):
        OH.spmv(ip, ix, v, x[::2], S.shape[0])
    p = SPR.build_plan(ip, ix, v, S.shape)
    with pytest.raises(ValueError):
        SPR.spmv_route(x[:-1].contiguous(), p)
    with pytest.raises(TypeError):
        SPR.spmv_route_ds(x.double(), p)


# ---------------------------------------------------------------------------
# sort-reduce kernels K5-K8 (csrc/sortreduce.cu)
# ---------------------------------------------------------------------------

SENT = SRD.SENTINEL


def _exact(kind, mon):
    """Values exact except fp32 plus (FP32_TOL * max|v|)."""
    return not (kind == "f32" and mon == "PLUS")


SR_CASES = [(C, kind, mon) for C in (128, 512, 2048, 8192)
            for kind, mon in (("i32", "PLUS"), ("f32", "PLUS"),
                              ("f32", "MIN"), ("f32", "MAX"),
                              ("bool", "LOR"), ("i32", "TIMES"))]


@pytest.mark.parametrize("C,kind,mon", SR_CASES)
def test_sort_reduce_rows_matches_plain(cuda_device, C, kind, mon):
    rng = np.random.default_rng(C)
    t = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    keys = GT.sr_runs(rng, C, runs=6)
    vals = GT.sr_values(rng, keys.size, kind)
    if mon == "TIMES":
        vals = np.where(rng.random(keys.size) < 0.9, 1, -1).astype(np.int32)
    args = (t(keys), t(vals), C, getattr(TM, mon))
    before = SRD.launches["sort_reduce_rows"]
    got = SRD.sort_reduce_rows(*args, logical=kind == "bool")
    torch.cuda.synchronize()
    assert SRD.launches["sort_reduce_rows"] == before + 1
    want = SRD.sort_reduce_rows_plain(*args, logical=kind == "bool")
    GT.sr_err(got, want, _exact(kind, mon))


@pytest.mark.parametrize("C", (512, 2048, 8192))
@pytest.mark.parametrize("want", (True, False))
def test_sort_reduce_tok_and_wide_match_plain(cuda_device, C, want):
    rng = np.random.default_rng(C + want)
    t = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    keys = GT.sr_runs(rng, C, runs=6)
    vals = GT.sr_values(rng, keys.size, "f32")
    toks = GT.sr_tokens(rng, keys, C)
    args = (t(keys), t(vals), t(toks), C, TM.PLUS)
    got = SRD.sort_reduce_rows_tok(*args, want_token=want)
    GT.sr_err(got, SRD.sort_reduce_rows_tok_plain(*args, want_token=want),
              _exact("f32", "PLUS"))
    kh, kl, tw = GT.sr_wide_keys(rng, C, runs=6)
    for toks_w in (None, t(tw)):
        args = (t(kh), t(kl), t(vals), C, TM.MIN)
        got = SRD.sort_reduce_rows_wide(*args, toks=toks_w, want_token=want)
        torch.cuda.synchronize()
        GT.sr_err(got, SRD.sort_reduce_rows_wide_plain(
            *args, toks=toks_w, want_token=want), _exact("f32", "MIN"))


@pytest.mark.parametrize("C", (128, 2048, 8192))
@pytest.mark.parametrize("want", (True, False))
def test_sort_reduce_pair1_matches_plain(cuda_device, C, want):
    rng = np.random.default_rng(3 * C + want)
    kt = torch.from_numpy(GT.sr_pair1_keys(rng, C, runs=5)).to(cuda_device)
    got = SRD.sort_reduce_pair1(kt, C, want_token=want)
    torch.cuda.synchronize()
    GT.sr_err(got, SRD.sort_reduce_pair1_plain(kt, C, want_token=want), True)


def test_sort_reduce_wrappers_refuse_bad_operands(cuda_device):
    keys = torch.full((4096,), SENT, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        SRD.sort_reduce_rows(keys, torch.zeros(4096, dtype=torch.float64,
                                               device=cuda_device),
                             2048, TM.PLUS)
    with pytest.raises(ValueError):
        SRD.sort_reduce_rows(keys, torch.zeros(4096, device=cuda_device),
                             2048, TM.ANY)
    with pytest.raises(ValueError):
        SRD.sort_reduce_rows(keys[:3000], torch.zeros(3000,
                                                      device=cuda_device),
                             2048, TM.PLUS)
