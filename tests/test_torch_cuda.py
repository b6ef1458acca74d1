"""The port's CUDA kernels (SpMV K1-K4, sort-reduce K5-K8 at every C, the
gather-permute K9) against their plain torch versions, and the fast
SpGEMM tier on K5/K6 against scipy, on a card.

Imports no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips where torch sees no card (a CUDA
kernel has no CPU mode)."""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from graphblas_tpu_torch import testing as GT
from graphblas_tpu_torch.core import monoid as TM
from graphblas_tpu_torch.kernels import sortreduce as SRD
from graphblas_tpu_torch.kernels import spmv_onehot as OH
from graphblas_tpu_torch.kernels import spmv_route as SPR
from graphblas_tpu_torch.kernels import static_route as STR

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


TILE = SPR._cuda.SPMV_TILE


def _random_degrees(rng):
    deg = rng.integers(0, 24, 5000)
    deg[::13] = 0
    return deg


# row lengths and (indices, values) shifts in elements
MERGE_CASES = {
    # row starts at every offset mod 4; both arrays one element past a
    # 16-byte boundary (16-byte loads after a 3-element head)
    "misaligned_rows_and_arrays": (_random_degrees, 1, 1),
    # indices and values reach 16-byte alignment at different elements
    # (4-byte loads throughout)
    "indices_shifted_only": (_random_degrees, 1, 0),
    # one row over three blocks and more
    "row_spans_3_blocks": (lambda r: np.concatenate(
        [r.integers(0, 9, 700), [3 * TILE + 100], r.integers(0, 9, 700)]),
        0, 0),
    # row 0 ends on the first tile's last step; row 2 (empty) and row 3
    # start the second; a later row ends just before a tile boundary
    "tile_ends_at_row_end": (lambda r: np.array(
        [TILE - 1, 3, 0, 5, TILE - 12, 1, 0, 0, 7]), 0, 0),
    "m1_1e5": (lambda r: np.array([100_000]), 0, 0),
    "nnz0": (lambda r: np.zeros(5000, np.int64), 0, 0),
}


def _degree_operands(rng, deg, device, n=200_000):
    ip = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    nnz = int(ip[-1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa
    S = sps.csr_matrix((rng.standard_normal(nnz).astype(np.float32),
                        rng.choice(n, nnz, replace=nnz > n), ip),
                       shape=(len(deg), n))
    x = t(rng.standard_normal(n).astype(np.float32))
    return S, t(ip), t(S.indices.astype(np.int32)), t(S.data), x


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_kernels_match_plain(cuda_device, case):
    """K2 (spmv_merge_f32) and K1 / K3 min-plus (spmv_merge_planned)
    against their plain versions where the merge path has its edges:
    misaligned rows and arrays, a row over three blocks, a tile ending on
    a row end, one row of 10^5 nonzeros, no nonzeros."""
    rng = np.random.default_rng(len(case))
    degrees, si, sv = MERGE_CASES[case]
    S, ip, ix, v, x = _degree_operands(rng, degrees(rng), cuda_device)
    ix, v = GT.shifted(ix, si), GT.shifted(v, sv)
    m = S.shape[0]
    before = (OH.launches, SPR.launches["spmv_route"])
    got2 = OH.spmv(ip, ix, v, x, m)
    p = SPR.build_plan(ip, ix, v, S.shape)
    got1 = SPR.spmv_route(x, p)
    got3 = SPR.spmv_route_monoid(x, p, add="min", mul="plus")
    torch.cuda.synchronize()
    assert (OH.launches, SPR.launches["spmv_route"]) == \
        (before[0] + 1, before[1] + 1)
    _check(got2, OH.spmv_plain(ip, ix, v, x, m), "plus", 1e-5)
    _check(got1, SPR.spmv_planned_plain(x, p, "plus", "times"), "plus",
           1e-5)
    _check(got3, SPR.spmv_planned_plain(x, p, "min", "plus"), "min", 0)


@pytest.mark.parametrize("add,mul", [(a, m) for a in ADDS for m in MULS]
                         + [("plus", "fp64")])
def test_planned_matches_plain(cuda_device, add, mul):
    """Every instantiation (15 fp32 semirings, fp64) on a matrix whose
    20000-nonzero row spans 10 tiles."""
    dt = np.float64 if mul == "fp64" else np.float32
    S, ip, ix, v, x = _skewed(np.random.default_rng(1), dt, cuda_device)
    p = SPR.build_plan(ip, ix, v, S.shape)
    if mul == "fp64":
        got, mul = SPR.spmv_route_ds(x, p), "times"
    else:
        got = SPR.spmv_route_monoid(x, p, add=add, mul=mul)
    torch.cuda.synchronize()
    want = SPR.spmv_planned_plain(x, p, add, mul)
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
    with pytest.raises(ValueError):                  # a tile missing
        SPR.spmv_route(x, dataclasses.replace(p, tile_row=p.tile_row[:-1]))


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


CLUSTER_MONOIDS = [("i32", "PLUS"), ("f32", "PLUS"), ("f32", "MIN"),
                   ("bool", "LOR"), ("i32", "MAX")]


@pytest.mark.parametrize("kind,mon", CLUSTER_MONOIDS)
def test_sort_reduce_cluster_matches_plain(cuda_device, kind, mon):
    """K5 and K6 at C = 32768 (a cluster of four blocks per run): run 2
    repeats one key over all 32768 slots, so the scan's carry crosses
    every block."""
    C = 32768
    rng = np.random.default_rng(len(kind) + len(mon))
    t = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    keys = GT.sr_runs(rng, C, runs=6)
    vals = GT.sr_values(rng, keys.size, kind)
    args = (t(keys), t(vals), C, getattr(TM, mon))
    kw = {"logical": kind == "bool"}
    before = SRD.launches_by_cap.get(("sort_reduce_rows", C), 0)
    got = SRD.sort_reduce_rows(*args, **kw)
    torch.cuda.synchronize()
    assert SRD.launches_by_cap[("sort_reduce_rows", C)] == before + 1
    GT.sr_err(got, SRD.sort_reduce_rows_plain(*args, **kw),
              _exact(kind, mon))
    toks = t(GT.sr_tokens(rng, keys, C))
    for want in (True, False):
        a2 = args[:2] + (toks,) + args[2:]
        got = SRD.sort_reduce_rows_tok(*a2, want_token=want, **kw)
        torch.cuda.synchronize()
        GT.sr_err(got, SRD.sort_reduce_rows_tok_plain(*a2, want_token=want,
                                                      **kw),
                  _exact(kind, mon))


@pytest.mark.parametrize("kind,mon", CLUSTER_MONOIDS)
def test_sort_reduce_cluster_edge_runs(cuda_device, kind, mon):
    """K5 and K6 at C = 32768 on the cluster kernel's edge runs
    (``testing.sr_edge_runs``), with the planes 16-byte aligned and one
    element past a 16-byte boundary (4-byte loads), each called twice:
    the same bits."""
    C = 32768
    rng = np.random.default_rng(7 + len(kind) + len(mon))
    t = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa: E731
    keys = GT.sr_edge_runs(rng, C)
    vals = GT.sr_values(rng, keys.size, kind)
    toks = GT.sr_tokens(rng, keys, C)
    kw = {"logical": kind == "bool"}
    for by in (0, 1):
        k, v, tk = (GT.shifted(t(a), by) for a in (keys, vals, toks))
        calls = [(SRD.sort_reduce_rows, SRD.sort_reduce_rows_plain,
                  (k, v, C, getattr(TM, mon)), kw)]
        calls += [(SRD.sort_reduce_rows_tok, SRD.sort_reduce_rows_tok_plain,
                   (k, v, tk, C, getattr(TM, mon)),
                   dict(kw, want_token=want)) for want in (True, False)]
        for fn, plain, args, kwargs in calls:
            got = fn(*args, **kwargs)
            again = fn(*args, **kwargs)
            torch.cuda.synchronize()
            GT.sr_err(got, plain(*args, **kwargs), _exact(kind, mon))
            assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("C", SRD.CAPS)
@pytest.mark.parametrize("edge,by", [(False, 0), (True, 0), (True, 1)])
def test_sort_reduce_kernels_match_plain_everywhere(cuda_device, C, edge,
                                                    by):
    """K5, K6, K7 and K8 at every C (2048 / C runs side by side in a
    256-thread block at C <= 2048, one run a 1024-thread block at 8192, a
    cluster of 4 such blocks at 32768; at 32768 this is also K7 and K8 on
    the cluster kernel): random runs whose count is no multiple of a
    block's runs, and the layouts' edge runs (``testing.sr_cases``), with the
    planes 16-byte aligned and one element past a 16-byte boundary; each
    call launches once, matches its plain version and gives the same bits
    twice."""
    rng = np.random.default_rng(C + 2 * edge + by)
    on = lambda a: GT.shifted(torch.from_numpy(a).to(cuda_device),  # noqa
                              by)
    for key, fn, plain, args, kw, exact in GT.sr_cases(rng, C, edge, on):
        before = SRD.launches_by_cap.get((fn.__name__, C), 0)
        got, again = fn(*args, **kw), fn(*args, **kw)
        torch.cuda.synchronize()
        assert SRD.launches_by_cap[(fn.__name__, C)] == before + 2, key
        GT.sr_err(got, plain(*args, **kw), exact)
        if not isinstance(got, tuple):
            got, again = (got,), (again,)
        assert all(torch.equal(a, b) for a, b in zip(got, again)), key


@pytest.mark.parametrize("n,dtype", [((1 << 20) + 3, torch.float32),
                                     (4097, torch.int32)])
def test_permute_gather_matches_plain(cuda_device, n, dtype):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)) \
        .to(dtype).to(cuda_device)
    plan = STR.GlobalPermutePlan(torch.from_numpy(rng.permutation(n))
                                 .to(cuda_device), n)
    before = STR.launches
    got = STR.global_permute(x, plan)
    torch.cuda.synchronize()
    assert STR.launches == before + 1
    assert torch.equal(got, STR.permute_plain(x, plan.perm))
    R = 32
    tile = x[:R * 128].reshape(R, 128).contiguous()
    pc = np.stack([rng.permutation(R) for _ in range(128)])
    want = np.take_along_axis(tile.cpu().numpy().T, pc, 1).T
    assert np.array_equal(STR.sublane_permute(tile, pc).cpu().numpy(), want)
    perm = rng.permutation(R * 128)
    assert np.array_equal(STR.tile_permute(tile, perm).cpu().numpy(),
                          tile.cpu().numpy().reshape(-1)[perm].reshape(R,
                                                                       128))


def test_fold_is_bitwise_repeatable(cuda_device):
    """K2 and the planned SpMV fold rows cut between tiles without
    atomics: two calls give the same bits."""
    S, ip, ix, v, x = _skewed(np.random.default_rng(4), np.float32,
                              cuda_device)
    assert torch.equal(OH.spmv(ip, ix, v, x, S.shape[0]),
                       OH.spmv(ip, ix, v, x, S.shape[0]))
    p = SPR.build_plan(ip, ix, v, S.shape)
    for add, mul in (("plus", "times"), ("min", "plus")):
        a = SPR.spmv_route_monoid(x, p, add=add, mul=mul)
        b = SPR.spmv_route_monoid(x, p, add=add, mul=mul)
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the fast SpGEMM tier (ops/spgemm_fast.py) on K5/K6
# ---------------------------------------------------------------------------

def _coo_csr(coo):
    r, c, v, shape = coo
    S = sps.csr_matrix((v, (r, c)), shape=shape)
    S.sum_duplicates()
    return S


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("C", (128, 32768))
def test_fast_tier_full_row_ends_in_empty_runs(cuda_device, monkeypatch, C,
                                               masked):
    """The last row of class C holds exactly C products and ends in A
    entries whose B rows are empty (zero-length runs one slot past the
    class's domain): the fast tier on K5/K6 against scipy, fp32 plus
    within 1e-5*max|c|."""
    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch.core import semiring as TS
    from graphblas_tpu_torch.ops import spgemm_sell as SGS
    monkeypatch.setattr(SGS, "MAX_SLOTS", 1)       # SELL declines
    SA, SB, SM = (_coo_csr(x) for x in GT.full_row_operands(
        C, np.random.default_rng(C)))
    P = (SA != 0).astype(np.int64) @ (SB != 0).astype(np.int64)
    want = SA.astype(np.float64) @ SB.astype(np.float64)
    kw = {}
    if masked:
        kw = dict(mask=gt.Matrix.from_scipy(SM, device=cuda_device),
                  desc=gt.Descriptor(mask_structure=True))
        P, want = P.multiply(SM != 0), want.multiply(SM != 0)
    name = "sort_reduce_rows_tok" if masked else "sort_reduce_rows"
    before = SRD.launches_by_cap.get((name, C), 0)
    on = lambda S: gt.Matrix.from_scipy(S, device=cuda_device)  # noqa
    got = gt.mxm(on(SA), on(SB), TS.PLUS_TIMES, **kw).to_scipy()
    assert SRD.launches_by_cap[(name, C)] > before
    assert got.nnz == P.nnz
    assert abs(got - want).max() <= GT.FP32_TOL * abs(want).max()
