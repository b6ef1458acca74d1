"""The port's CUDA kernels (SpMV K1-K4, sort-reduce K5-K8 at every C, the
gather-permute K9 at every payload width) against their plain torch
versions, the fast SpGEMM tier on K5/K6 against scipy, the union merge,
wait(), the CSR <-> CSC reorient and the distributed tier (a world-size-1
NCCL group) against the CPU's results, a second sssp that finds its flip
and plan kept (no sort, no K9, no plan build), and the ``host_syncs`` counter
against torch's own report of synchronising calls, on a card.

Imports no JAX, so it runs where only torch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips where torch sees no card (a CUDA
kernel has no CPU mode; the torch ops on unsigned dtypes differ too)."""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import graphblas_tpu_torch as gt
from graphblas_tpu_torch import testing as GT
from graphblas_tpu_torch.core import types as TT
from graphblas_tpu_torch.core import monoid as TM
from graphblas_tpu_torch.kernels import _cuda
from graphblas_tpu_torch.kernels import sortreduce as SRD
from graphblas_tpu_torch.kernels import spmv_onehot as OH
from graphblas_tpu_torch.kernels import spmv_route as SPR
from graphblas_tpu_torch.kernels import static_route as STR
import torch_dist_cases as PD

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


@pytest.mark.parametrize("case", GT.TILING_EDGES + ("rmat18",))
def test_partition_kernel_matches_tile_rows(cuda_device, case):
    """A plan built from CUDA tensors tiles on the card: ``spmv_partition``
    gives ``_tile_rows``'s bits, in one launch, with no host sync (torch's
    sync report raises on one) and no digest."""
    ip = GT.tiling_indptr(case, TILE, np.random.default_rng(15))
    m, nnz = ip.size - 1, int(ip[-1])
    t = lambda a: torch.from_numpy(a).to(cuda_device)  # noqa
    ipt, ix = t(ip), t(np.zeros(nnz, np.int32))
    v = t(np.ones(nnz, np.float32))
    SPR.build_plan(ipt, ix, v, (m, 7))        # builds and loads the kernel
    torch.cuda.synchronize()
    before = SPR.launches["spmv_partition"]
    gt.trace_reset()
    gt.set_option("trace", True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        p = SPR.build_plan(ipt, ix, v, (m, 7))
        c = gt.trace_counters()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        gt.set_option("trace", False)
        gt.trace_reset()
    assert SPR.launches["spmv_partition"] == before + 1
    assert c.get("host_syncs", 0) == 0 and c["spmv_plan.card_tilings"] == 1
    assert p.tile_row.device == ipt.device and p.digest is None
    assert p.nnz == nnz and p.values is v
    np.testing.assert_array_equal(p.tile_row.cpu().numpy(),
                                  SPR._tile_rows(ip))


# one good plan, then a CSR whose indptr[m] (5) is not indices.numel()
# (4); the exit code says which sync raised
_MALFORMED = textwrap.dedent("""
    import sys
    import torch
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    t = lambda a, dt: torch.tensor(a, dtype=dt, device="cuda")
    ix, v = t([0, 1, 2, 3], torch.int32), t([1.0] * 4, torch.float32)
    SPR.build_plan(t([0, 3, 4], torch.int32), ix, v, (2, 7))
    torch.cuda.synchronize()
    SPR.build_plan(t([0, 3, 5], torch.int32), ix, v, (2, 7))
    try:
        torch.cuda.synchronize()
    except RuntimeError as e:
        print("raised:", e)
        sys.exit(3)
    sys.exit(0)
""")


def test_partition_kernel_stops_a_malformed_csr(cuda_device):
    """The card's build reads nothing back, so ``spmv_partition`` holds
    indptr[m] to ``indices.numel()`` itself: a mismatch is a device-side
    assert, raised at the next sync (in a process of its own: it ends the
    CUDA context)."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    r = subprocess.run([sys.executable, "-c", _MALFORMED], cwd=root,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 3, (r.returncode, r.stdout, r.stderr)
    assert "device-side assert" in r.stdout, r.stdout


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


@pytest.mark.parametrize("pdt", [torch.int32, torch.int64])
@pytest.mark.parametrize("kind", list(GT.K9_PAYLOADS))
def test_permute_rows_matches_plain(cuda_device, kind, pdt):
    """K9 at every payload width, alone and beside the int32 row ids, on
    an odd tail, from a source and into outputs one row past their
    alignment, in the passes the launcher picks and in one and three
    L2-blocked passes: bitwise the plain version, and bitwise again on a
    second call."""
    rng = np.random.default_rng(90)
    n = (1 << 16) + 37
    x = GT.k9_payload(rng, n, kind)
    ids = torch.from_numpy(rng.integers(0, 1 << 20, n).astype(np.int32))
    perm = torch.from_numpy(rng.permutation(n)).to(pdt)
    want_x, want_ids = STR.permute_plain(x, perm), ids[perm.long()]
    xc, idc, pc = (t.to(cuda_device) for t in (x, ids, perm))
    before = STR.launches
    one = STR.permute_rows(xc, pc)
    gi, gx = STR.permute_rows(idc, pc, xc)
    gi2, gx2 = STR.permute_rows(idc, pc, xc)
    torch.cuda.synchronize()
    assert STR.launches == before + 3
    assert GT.same_bits(one, want_x) and GT.same_bits(gx, want_x)
    assert GT.same_bits(gi, want_ids)
    assert GT.same_bits(gi2, gi) and GT.same_bits(gx2, gx)
    rb = [4, x.element_size() * x[0].numel()]
    xs = [GT.shifted(idc, 1), GT.shifted(xc, 1)]
    for passes in (0, 1, 3):     # 0: the launcher's choice
        outs = [GT.shifted(torch.zeros_like(t), 1) for t in (idc, xc)]
        _cuda.permute_gather(pc, xs, outs, rb, n, passes)
        torch.cuda.synchronize()
        assert GT.same_bits(outs[0], want_ids), passes
        assert GT.same_bits(outs[1], want_x), passes


@pytest.mark.parametrize("dtype", [torch.int8, torch.int16, torch.float32,
                                   torch.float64])
def test_global_permute_plan_matches_plain(cuda_device, dtype):
    """``global_permute`` through a plan at 1, 2, 4 and 8-byte elements,
    from a source one element past its alignment: one K9 launch a call,
    bitwise the plain version, and bitwise again on a second call."""
    rng = np.random.default_rng(92)
    n = 3 * 16384 + 1234
    x = GT.shifted(torch.from_numpy(rng.standard_normal(n) * 100).to(dtype)
                   .to(cuda_device), 1)
    plan = STR.GlobalPermutePlan(torch.from_numpy(rng.permutation(n))
                                 .to(cuda_device), n)
    before = STR.launches
    got, again = STR.global_permute(x, plan), STR.global_permute(x, plan)
    torch.cuda.synchronize()
    assert STR.launches == before + 2
    assert GT.same_bits(got, STR.permute_plain(x, plan.perm))
    assert GT.same_bits(again, got)


def test_permute_rows_refuses_bad_operands(cuda_device):
    x = torch.arange(10, dtype=torch.float32, device=cuda_device)
    perm = torch.arange(10, device=cuda_device)
    with pytest.raises(TypeError):
        STR.permute_rows(x, perm.float())
    with pytest.raises(ValueError):                 # three payloads
        STR.permute_rows(x, perm, x, x)
    with pytest.raises(ValueError):                 # not contiguous
        STR.permute_rows(torch.zeros(10, 2, device=cuda_device)[:, 0], perm)
    with pytest.raises(ValueError):                 # another length
        STR.permute_rows(x, perm, x[:9])
    with pytest.raises(ValueError):                 # the payload elsewhere
        STR.permute_rows(x.cpu(), perm)
    assert STR.permute_rows(x, perm[:0]).shape == (0,)



@pytest.mark.parametrize("algo", ["sssp", "pagerank"])
def test_host_syncs_count_every_sync_on_card(cuda_device, algo):
    """One fused call with a plan at RMAT-12: the ``host_syncs`` counter
    equals the synchronising CUDA calls torch reports
    (``set_sync_debug_mode("warn")``): the loop's stop tests, and nothing
    else (the plan is built on the card)."""
    import warnings

    from graphblas_tpu_torch import algorithms as AL
    rng = np.random.default_rng(14)
    r, c, n = GT.rmat_edges(12, 8, rng)
    w = (rng.random(r.size) + 0.05).astype(np.float32)
    A = gt.Matrix.from_coo(r, c, w, (n, n), dup="min", device=cuda_device)

    def call():
        if algo == "sssp":
            return AL.sssp(A, 3, optimize=True)
        return AL.pagerank_fused(A, 0.85, 1e-6, 100, optimize=True)[0]

    call()                                  # builds and loads the kernels
    torch.cuda.synchronize()
    gt.trace_reset()
    gt.set_option("trace", True)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            call()
        counted = gt.trace_counters()["host_syncs"]
    finally:
        torch.cuda.set_sync_debug_mode("default")
        gt.set_option("trace", False)
        gt.trace_reset()
    syncs = [f"{x.filename}:{x.lineno}" for x in seen
             if "synchroniz" in str(x.message)]
    assert counted == len(syncs) and counted >= 3, (counted, syncs)


@pytest.mark.parametrize("dtype", ["FP32", "FP64", "INT8", "BOOL", "UINT64",
                                   "FC64", "iso"])
def test_reorient_on_card_matches_cpu(cuda_device, dtype):
    """A.to_format(SPARSE, COL) of an RMAT-14 matrix stored by row runs
    its row ids and values through one K9 launch and gives the CPU's
    arrays bitwise; and back by row gives A's."""
    rng = np.random.default_rng(91)
    r, c, n = GT.rmat_edges(14, 16, rng)
    iso = dtype == "iso"
    ty = TT.FP32 if iso else getattr(TT, dtype)
    vals = GT.k9_payload(rng, r.size, {"FP32": "fp32", "FP64": "fp64",
                                       "INT8": "int8", "BOOL": "bool",
                                       "UINT64": "uint64", "FC64": "fc64",
                                       "iso": "fp32"}[dtype])
    vals = vals[:1].numpy() if iso else vals.numpy()
    mats = {d: gt.Matrix.from_coo(r, c, vals[0] if iso else vals, (n, n),
                                  dtype=ty, dup="first", iso=iso, device=d)
            for d in ("cpu", "cuda")}
    before = STR.launches
    cols = {d: A.to_format(gt.SPARSE, gt.COL) for d, A in mats.items()}
    torch.cuda.synchronize()
    assert STR.launches == before + 1
    back = cols["cuda"].to_format(gt.SPARSE, gt.ROW)
    for name in ("indptr", "indices", "values"):
        assert GT.same_bits(getattr(cols["cuda"], name),
                            getattr(cols["cpu"], name)), name
        assert GT.same_bits(getattr(back, name),
                            getattr(mats["cuda"], name)), name


def test_sssp_again_finds_its_flip_and_plan_on_card(cuda_device):
    """sssp(A, r, optimize=True) twice on an RMAT-18 graph: the second call
    finds A's flip by column and its plan, so it launches no radix sort
    and no K9 and builds no plan, and its distances equal the first
    call's and a fresh matrix's bitwise."""
    from torch.profiler import ProfilerActivity, profile

    from graphblas_tpu_torch import algorithms as AL
    from graphblas_tpu_torch.algorithms import graph as AG
    from graphblas_tpu_torch.core import convert as CV
    for cache in (CV._reorients, AG._pattern_plans, AG._sssp_plans):
        cache.clear()
    rng = np.random.default_rng(18)
    r, c, n = GT.rmat_edges(18, 16, rng)
    w = (rng.random(r.size) + 0.05).astype(np.float32)

    def graph():
        return gt.Matrix.from_coo(r, c, w, (n, n), dup="min",
                                  device=cuda_device)

    A, root = graph(), int(r[0])
    first = AL.sssp(A, root, optimize=True)
    torch.cuda.synchronize()
    k9, kp = STR.launches, SPR.launches["spmv_partition"]
    gt.trace_reset()
    gt.set_option("trace", True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            again = AL.sssp(A, root, optimize=True)
            torch.cuda.synchronize()
        counted = gt.trace_counters()
    finally:
        gt.set_option("trace", False)
        gt.trace_reset()
    kernels = {e.key for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("spmv_merge" in k for k in kernels), kernels
    assert not [k for k in kernels if "RadixSort" in k or any(
        t in k for t in ("pack_kernel", "gather_pairs_kernel",
                         "permute_gather_kernel"))], kernels
    assert (STR.launches, SPR.launches["spmv_partition"]) == (k9, kp)
    assert counted.get("convert.reorient_hits") == 1, counted
    assert "convert.reorients" not in counted, counted
    assert "spmv_plan.builds" not in counted, counted
    fresh = AL.sssp(graph(), root, optimize=True)
    assert GT.same_bits(again, first) and GT.same_bits(fresh, first)


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


def test_triangle_count_on_card_matches_reference(cuda_device):
    """triangle_count on the benchmark's Kronecker graph at scale 16,
    built as ``gbbench/run.py`` builds it (L relabelled by degree, SELL's
    fused count, its hub rows on the classic path), equals the plain
    reference's count, cold and warm, and drives the sort-reduce
    kernels."""
    from gbbench import catalog, graph
    cfg = catalog.load_json(catalog.HERE / "configs" /
                            "graph500-kron-tc.json")
    e = graph.generate(cfg, 2**31 + 16, cuda_device, 16)
    rows, cols, vals = graph.stored(e, cfg)
    A = gt.Matrix.from_coo(rows, cols, vals, (e.n, e.n),
                           dup=cfg["duplicates"], orient=gt.ROW)
    before = sum(SRD.launches.values())
    got = gt.triangle_count(A)
    assert gt.triangle_count(A) == got
    assert sum(SRD.launches.values()) > before
    ref = catalog.module("reference", "triangles")
    want = ref.solve(ref.prepare(e, cfg, {}, torch.float64), None, {},
                     torch.float64)
    assert got == want > 0


def _raw(t):
    """The bytes of a tensor: bitwise comparison whatever its dtype."""
    return t.contiguous().view(torch.uint8)


def _payload(rng, n, dt):
    """``n`` values of ``dt`` from random int64 bits: floats of any bit
    pattern (NaN payloads and -0.0 among them), unsigned over their whole
    range, complex from two such doubles."""
    bits = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, n))
    if dt.is_complex:
        return torch.complex(bits.double(), -bits.double()).to(dt)
    if dt in (torch.float64, torch.uint64):
        return bits.view(dt)
    if dt == torch.float32:
        return bits.to(torch.int32).view(dt)
    return bits.to(torch.int16).view(dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.uint64,
                                torch.uint16, torch.complex128])
def test_union_merge_on_card_matches_cpu(cuda_device, dt):
    """The union merge on the card equals the CPU's bitwise and leaves its
    results on the card."""
    from graphblas_tpu_torch.kernels import segment as K
    rng = np.random.default_rng(30)
    ka = torch.from_numpy(np.unique(rng.integers(0, 1 << 22, 200_000)))
    kb = torch.from_numpy(np.unique(rng.integers(0, 1 << 22, 300_000)))
    cpu = (ka, _payload(rng, ka.numel(), dt), kb,
           _payload(rng, kb.numel(), dt))
    want = K.union_merge(*cpu)
    got = K.union_merge(*(t.to(cuda_device) for t in cpu))
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        assert torch.equal(_raw(g.cpu()), _raw(w))


def _unsigned_operands(rng, npdt, n=1 << 16):
    """Values over the type's whole range, both sides of the top bit, with
    0, 1, the maximum and divisors 0 and small among them."""
    top = np.iinfo(npdt).max
    half = npdt.type(1) << npdt.type(8 * npdt.itemsize - 1)
    a = rng.integers(0, top, n, dtype=npdt, endpoint=True)
    b = rng.integers(0, top, n, dtype=npdt, endpoint=True)
    a[:8] = [0, 1, top, half, half + npdt.type(1), top, 7, half - 1]
    b[:8] = [0, 0, 1, top, half, half - npdt.type(1), 0, half + 3]
    b[8::9] = 0
    b[9::11] = rng.integers(1, 4, b[9::11].size, dtype=npdt)
    return a, b


@pytest.mark.parametrize("dt", [torch.uint16, torch.uint32, torch.uint64])
def test_unsigned_ops_on_card_match_cpu(cuda_device, dt):
    """Unsigned order, division and reductions on the card, where torch
    has no compare, gather or sort for these dtypes: MIN/MAX, the
    comparators and DIV equal numpy's unsigned results (values above the
    top bit ordered after the others); wrapping + - x, RDIV, MINV, the
    bitwise ops, order_key's sort and segment_reduce / full_reduce equal
    the CPU's; every result stays on the card."""
    from graphblas_tpu_torch.core import ops as TO
    from graphblas_tpu_torch.core import types as TT
    from graphblas_tpu_torch.kernels import segment as K
    rng = np.random.default_rng(32)
    npdt = torch.empty(0, dtype=dt).numpy().dtype
    a, b = _unsigned_operands(rng, npdt)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ca, cb = ta.to(cuda_device), tb.to(cuda_device)

    def on_card(t):
        assert t.device.type == "cuda"
        return t.cpu()

    top = int(np.iinfo(npdt).max)
    div = np.array([0 if y == 0 and x == 0 else top if y == 0 else x // y
                    for x, y in zip(a.tolist(), b.tolist())], npdt)
    for name, want in (("MIN", np.minimum(a, b)), ("MAX", np.maximum(a, b)),
                       ("LT", a < b), ("GE", a >= b), ("DIV", div)):
        got = on_card(getattr(TO, name).fn(ca, cb)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("PLUS", "MINUS", "TIMES", "RDIV", "BXNOR", "BAND"):
        op = getattr(TO, name).fn
        assert torch.equal(_raw(on_card(op(ca, cb))), _raw(op(ta, tb))), \
            name
    assert torch.equal(_raw(on_card(TO.MINV.fn(cb))), _raw(TO.MINV.fn(tb)))
    c = TT.carry(ca)
    key_dt = torch.uint64 if dt == torch.uint64 else c.dtype
    k, _ = torch.sort(TT.order_key(c, key_dt))
    srt = TT.uncarry(TT.order_key(k, key_dt), dt)
    np.testing.assert_array_equal(on_card(srt).numpy(), np.sort(a))
    seg = torch.from_numpy(np.sort(rng.integers(0, 700, a.size)))
    for mon in ("PLUS", "TIMES", "MIN", "MAX", "BOR", "BXNOR"):
        tm = getattr(TM, mon)
        got = on_card(K.segment_reduce(ca, seg.to(cuda_device), 701, tm))
        assert torch.equal(_raw(got), _raw(K.segment_reduce(ta, seg, 701,
                                                            tm))), mon
        assert torch.equal(_raw(on_card(K.full_reduce(ca, tm)).reshape(1)),
                           _raw(K.full_reduce(ta, tm).reshape(1))), mon


@pytest.mark.parametrize("fmt", ["sparse", "hyper", "bitmap", "full"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint64])
def test_wait_on_card_matches_cpu(cuda_device, fmt, dtype):
    """set/remove then wait() on the card equals the CPU's, ewise_add of
    the result too, and every tensor stays on the card."""
    import graphblas_tpu_torch as gt
    rng = np.random.default_rng(31)
    n = 3000
    S = sps.random(n, n, 0.002 if fmt != "full" else 1.0, random_state=rng,
                   format="csr")
    S.data = rng.integers(1, 255, S.nnz).astype(dtype)
    if dtype == np.uint64:
        S.data[::3] += np.uint64(2 ** 63)
    events = GT.pending_events(rng, (n, n), 5000, 1500,
                               np.argwhere(S.toarray() != 0)[:20000])
    out = []
    for dev in ("cpu", "cuda"):
        A = gt.Matrix.from_scipy(S, device=dev).to_format(fmt)
        for op, i, j, v in events:
            if op == "set":
                A.set_element(i, j, v)
            else:
                A.remove_element(i, j)
        A.wait()
        C = gt.ewise_add(A, A, gt.operators.PLUS)
        out.append((A, C))
    for a, b in zip(*out):
        for f in ("indptr", "indices", "values", "bitmap"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if y is not None:
                assert y.device.type == "cuda"
                assert torch.equal(_raw(y.cpu()), _raw(x))


def _same_on_card(cpu, card):
    """A port object computed on the CPU and on the card: the same class
    and metadata, every tensor on the card and bitwise equal."""
    assert type(cpu) is type(card)
    assert (cpu.shape, cpu.dtype, cpu.fmt, cpu.orient, cpu.iso) == \
        (card.shape, card.dtype, card.fmt, card.orient, card.iso)
    for f in ("indptr", "h", "indices", "values", "bitmap"):
        x, y = getattr(cpu, f), getattr(card, f)
        assert (x is None) == (y is None), f
        if y is not None:
            assert y.device.type == "cuda", f
            assert torch.equal(_raw(y.cpu()), _raw(x)), f


@pytest.mark.parametrize("fmt", ["sparse", "bitmap"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint64])
def test_op_layer_on_card_matches_cpu(cuda_device, fmt, dtype):
    """extract (unique and repeated indices), subassign under a mask with
    an accum, assign under a global mask, C<M> = x, kron, split/concat,
    sort by GT, reshape, resize and diag on the card equal the CPU's,
    bitwise (UINT64 values on both sides of 2^63: the card moves them
    through the signed views)."""
    import graphblas_tpu_torch as gt
    ops = gt.operators
    rng = np.random.default_rng(37)
    n = 400
    S = sps.random(n, n, 0.03, random_state=rng, format="csr")
    S.data = rng.integers(1, 255, S.nnz).astype(dtype)
    if dtype == np.uint64:
        S.data[::3] += np.uint64(2 ** 63)
    Mv = S.copy()
    Mv.data = rng.random(S.nnz) < 0.5          # explicit false values
    I = np.sort(rng.choice(n, 150, replace=False))
    J = np.sort(rng.choice(n, 120, replace=False))
    Ir = rng.integers(0, n, 90)
    big = dtype(2 ** 64 - 7) if dtype == np.uint64 else dtype(7.5)
    out = []
    for dev in ("cpu", "cuda"):
        A = gt.Matrix.from_scipy(S, device=dev).to_format(fmt)
        M = gt.Matrix.from_scipy(Mv, device=dev)
        R = gt.extract(A, I, J)
        Mr = gt.extract(M, I, J)
        res = [R, gt.extract(A, Ir, Ir[::-1]),
               gt.subassign(A.dup(), R, I, J, mask=Mr, accum=ops.PLUS),
               gt.assign(A.dup(), R, I, J, mask=M),
               gt.assign(A.to_format("sparse"), big, mask=M),
               gt.kronecker(R, gt.extract(A, I[:9], J[:7]), ops.TIMES),
               gt.concat(gt.split(A, [150, 250], [100, 100, 200])),
               *gt.sort(A, ops.GT), A.reshape(200, 800),
               gt.diag(gt.vector_diag(A, 1), -2)]
        A.resize(n + 20, n - 30)
        out.append(res + [A])
    for cpu, card in zip(*out):
        _same_on_card(cpu, card)


# ---------------------------------------------------------------------------
# the distributed tier on the card: a world-size-1 NCCL group
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_group(tmp_path_factory):
    """A world-size-1 NCCL group in this process (the card is one rank)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL has no CPU mode")
    from graphblas_tpu_torch.parallel import launch
    path = tmp_path_factory.mktemp("nccl") / "rendezvous"
    launch.init(0, 1, "cuda:0", f"file://{path}")
    yield
    launch.shutdown()


# the shared fp32 DistMatrix walks K2, K3 (building the plan), K3, K1, K4
DIST_ON_CARD = [*PD.SHARED_F32, "mxv_f64", "min_plus_f64", "ring_min_plus",
                "mask_accum", "vxm", "bfs", "pagerank", "u64_vxm_min",
                "mxv_2d_f32"]


def test_dist_on_card_matches_cpu(nccl_group):
    """dist_mxv on each kernel tier (plus-times, min-plus with empty rows,
    max-second, fp64), vxm, BFS, PageRank, UINT64 min-plus vxm and the
    1x1 2-D mxv on the card's NCCL rank against the same cases on one gloo
    rank on the CPU (the kernels' plain versions): the same tiers; min/max,
    ints and levels exact, fp32 sums within 1e-5 * max|y|, fp64 within
    1e-12 * max|y|."""
    from graphblas_tpu_torch.parallel import launch
    card = PD.rank_main(0, 1, torch.device("cuda", 0), DIST_ON_CARD)
    cpu = launch.spawn(PD.rank_main, 1, "cpu", DIST_ON_CARD)[0]
    assert card["tiers"] == cpu["tiers"]
    assert card["tiers"]["mxv_f32"] == ["merge"]
    assert card["tiers"]["min_plus_f32"] == ["route_monoid min_plus"]
    assert card["tiers"]["mxv_f32_planned"] == ["route"]
    assert card["tiers"]["mxv_f32_to_f64"] == ["route_ds"]
    cases = {**PD.spmv_cases(), **PD.mxm_cases(1)}
    for name in DIST_ON_CARD:
        got, want = card[name], cpu[name]
        assert got.dtype == want.dtype and got.shape == want.shape, name
        sr = cases[name].get("sr")
        if got.dtype.kind in "biu" or (isinstance(sr, tuple)
                                       and sr[0] in ("MIN", "MAX")):
            np.testing.assert_array_equal(got, want, err_msg=name)
            continue
        tol = 1e-5 if got.dtype == np.float32 else 1e-12
        assert np.abs(got.astype(np.float64) - want).max() <= \
            tol * np.abs(want).max(), name
    empty = np.diff(cases["min_plus_f32"]["S"].indptr) == 0
    assert empty.any() and np.all(card["min_plus_f32"][empty] == np.inf)


def test_dist_mxm_on_card_matches_mxm(nccl_group):
    """dist_mxm on the card's rank is the port's mxm of the rank's rows
    (SELL, K5): bitwise the mxm of the whole operands."""
    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch import parallel as par
    case = PD.mxm_cases(1)["mxm_f32"]
    A = gt.Matrix.from_scipy(case["S"], device="cuda")
    B = gt.Matrix.from_scipy(case["B"], device="cuda")
    mesh = par.make_mesh(1)
    DA = par.DistMatrix.from_matrix(A, mesh)
    DB = par.DistMatrix.from_matrix(B, mesh)
    k5 = SRD.launches["sort_reduce_rows"]
    DC = par.dist_mxm(DA, DB)
    assert SRD.launches["sort_reduce_rows"] > k5
    C = gt.mxm(A, B, gt.semiring.PLUS_TIMES)
    assert DC.nnz == C.nvals
    assert torch.equal(DC.indptr, C.indptr)
    assert torch.equal(DC.indices[:DC.nnz], C.indices)
    assert torch.equal(DC.values[:DC.nnz], C.values)


def test_threads_first_launch_k2_from_cold_build(cuda_device, tmp_path,
                                                 monkeypatch):
    """Four threads first-launch K2 together from an empty build
    directory (each under its own Context, as examples/context_demo's
    threads): spmv.cu is built and loaded once, no temporary file is
    left, and the four results are bitwise equal to each other and to
    one more K2 call."""
    import threading
    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch.core import context
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "_libs", {})
    rng = np.random.default_rng(41)
    S, ip, ix, v, x = _degree_operands(rng, _random_degrees(rng),
                                       cuda_device)
    m = S.shape[0]
    start = threading.Barrier(4)
    out, errors = {}, []
    before = OH.launches

    def run(tid):
        try:
            with gt.Context(device=cuda_device, name=f"worker{tid}"):
                xs = context.device_put_ctx(x.cpu())
                start.wait()
                out[tid] = OH.spmv(ip, ix, v, xs, m)
        except Exception as exc:      # noqa: BLE001 - reported below
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    assert OH.launches == before + 4
    assert [p.name for p in tmp_path.glob("*.so")] == \
        [_cuda.library_path("spmv").name]
    assert not list(tmp_path.glob("*.tmp"))
    ref = OH.spmv(ip, ix, v, x, m)
    for tid in range(4):
        assert torch.equal(out[tid], ref), tid
    _check(ref, OH.spmv_plain(ip, ix, v, x, m), "plus", 1e-5)
