#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (graphblas_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (more for the per-graph phases):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile graphblas_tpu_torch/csrc/{spmv,sortreduce,permute}.cu,
     one nvcc each, started together; ptxas's registers, spills and shared
     memory of the sort-reduce kernels (one block at C <= 8192, a cluster
     at C = 32768);
  3. kernels: every kernel against its plain torch version on the card —
     the SpMV kernels K1-K4 at small random sizes with empty rows and one
     row of 10^5 nonzeros (exact for min/max, 1e-5*max|y| for fp32 plus,
     1e-12*max|y| for fp64), K2 and K1 also with the indices and values
     one element past a 16-byte boundary (together, and the indices
     alone), the sort-reduce kernels K5-K8 at every C (128, 512, 2048,
     8192, 32768) on random runs with many duplicate keys, empty,
     all-SENTINEL, full runs and one key repeated over a whole run, and on
     the layouts' edge runs (testing.sr_edge_runs, sr_wide_edge_keys,
     sr_pair1_edge_runs) with the planes aligned and one element past a
     16-byte boundary (keys exact; values exact for int32, bool, min/max
     and K7, 1e-5*max|v| for fp32 plus), every call twice bitwise equal
     (K7 and K8 at 32768 launch here only: no path runs them), K9 on a
     random permutation of 2^24 + 777 fp32 elements (exact), and two K2,
     two K1 and two K3 min-plus calls at graph (b) bitwise equal;
  4. SpMV main path at real size through the public API on two graphs —
     (a) bench.py's uniform graph (n = 2^20, degree 16, seed 0) and
     (b) RMAT scale 20, edge factor 16, seed 7 (bench_real.py's graph,
     from the port's copy of its generator), a power-law graph — with
     mxv/vxm (unplanned, planned with mask + accum, min-plus), the fp64
     planned SpMV, CSC conversion, PageRank, BFS and SSSP, each checked
     against scipy/numpy on the host;
  5. launch counts: every SpMV kernel launched during phase 4;
  6. SpMV times: each kernel, its plain version and one torch.sparse CSR
     product (K1, K2, K4) at graphs (a) and (b) (CUDA events, median of
     20 after warm-up) beside the bound of its bytes, and K1's and K2's
     two passes (the merge-path kernel, the carry pass) apart, by their
     device time under torch.profiler; at graph (a) also K1's kernel with
     the columns redrawn in [0, 2^16) and [0, 2^13) (x in L2 only, x in
     L1: what the x gather costs);
  7. SpGEMM main path (the SELL tier) through gt.mxm, gt.select and
     triangle_count, with the sort-reduce launch counts set to 0 before
     and read after (in total and by C): (a) C = A*A on graph (a) (K5;
     nnz 268,406,919, 4096 sampled rows exact against scipy, fp64
     checksum (S'1).(S1)), triangle_count = 647 (K7; also scipy's
     sum((L L').*L)), the materialised masked count mxm(L, L', PLUS_PAIR,
     mask=L) (K6) and a complemented-mask product (sampled rows exact);
     (b) triangle_count(RMAT-18) = 19,595,360; (c) C = A*A and C<A> = A*A
     with n = 2^23 columns, degree 2 (the wide keys, K8; sampled rows
     exact); every sort-reduce kernel launched, and the native layout
     sweep ran (never the Python one);
  8. sort-reduce times: each of K5-K8 and its plain version on the
     inputs the main path gave it (its first launch), beside the bound of
     its bytes and one torch.sort of the same runs' keys (a sort alone);
  9. wall times of (a) A*A, (a) and (b) triangle_count, cold and warm;
 10. where the SpGEMM time goes: one warm A*A (a) and one warm
     triangle_count (b), with the SELL phases timed on the host, then
     under torch.profiler (device busy share, device time by operator
     and by kernel, and the sort-reduce kernels' by C);
 11. the fast SpGEMM tier at full size, which takes the products SELL
     declines (RMAT-18's A*A, 2.9e9 products: a slot domain beyond
     int32), the launch counts set to 0 before and read after: RMAT-18
     A*A (nnz 1,278,009,346, 4096 sampled rows exact, checksum) and C<A>
     = A*A (structural mask; equal to A*A on A's pattern, sampled rows
     exact); rows and padded slots per sort class and the fallback rows;
     K5 launched at every C in (128 ... 32768) and K6 at 32768; wall
     times cold and warm; one warm RMAT-18 A*A traced as in phase 10;
 12. K5 and K6 at C = 32768 and their plain versions on the fast tier's
     first inputs at that C, K7 and K8 at 32768 on inputs of that size,
     beside the bound of their bytes and a torch.sort; each sort-reduce
     kernel's blocks or clusters resident at once, registers, spills and
     shared memory on this card;
 13. K9: global_permute of graph (a)'s CSR -> CSC value permutation
     (launches counted), exact against the plain version and scipy's CSC
     values, timed beside its bound and one torch.take.
The two lines before the last are the card (nvidia-smi) and one JSON
object describing the kernels of the main paths (K7 and K8 at 32768, which
no path runs, print their checks and times in phases 3 and 12 only); the
last line is the result JSON.  Any
failure raises and exits non-zero.  Needs one CUDA card and the
graphblas_tpu_torch package beside this script; exits non-zero, with no
result, without either.
"""

import json
import re
import subprocess
import sys
import time

import numpy as np

FP32_TOL = 1e-5      # fp32 plus: summation order differs
FP64_TOL = 1e-12
RELERR_GUARD = 1e-4  # bench.py's SpMV correctness guard
HBM_BYTES_S = 3.35e12   # H100 SXM device-memory rate (data sheet)
FP32_OPS_S = 67e12      # H100 SXM fp32 outside the tensor cores
ADDS = ("plus", "min", "max")
MULS = ("times", "plus", "first", "second", "pair")
SPMV_SRC = "graphblas_tpu_torch/csrc/spmv.cu"
SR_SRC = "graphblas_tpu_torch/csrc/sortreduce.cu"
PERMUTE_SRC = "graphblas_tpu_torch/csrc/permute.cu"
KERNELS = {   # key: (name, source, TPU kernel replaced)
    "K1": ("spmv_merge_planned<float,plus,times>", SPMV_SRC,
           "graphblas_tpu/kernels/spmv_route.py:1446"),
    "K2": ("spmv_merge_f32", SPMV_SRC,
           "graphblas_tpu/kernels/spmv_onehot.py:257"),
    "K3": ("spmv_merge_planned<float,{min,max,plus}x{times,plus,first,"
           "second,pair}>", SPMV_SRC,
           "graphblas_tpu/kernels/spmv_route.py:1767"),
    "K4": ("spmv_merge_planned<double,plus,times>", SPMV_SRC,
           "graphblas_tpu/kernels/spmv_route.py:1581"),
    "K5": ("sort_reduce_block_regs_kernel (sort_reduce_rows)", SR_SRC,
           "graphblas_tpu/kernels/sortreduce.py:252"),
    "K6": ("sort_reduce_block_regs_kernel + tokens (sort_reduce_rows_tok)",
           SR_SRC, "graphblas_tpu/kernels/sortreduce.py:465"),
    "K7": ("sort_reduce_block_regs_kernel, pair counts (sort_reduce_pair1)",
           SR_SRC, "graphblas_tpu/kernels/sortreduce.py:360"),
    "K8": ("sort_reduce_block_regs_kernel + key2 (sort_reduce_rows_wide)",
           SR_SRC, "graphblas_tpu/kernels/sortreduce.py:435"),
    "K5@32768": ("sort_reduce_cluster_regs_kernel (sort_reduce_rows, "
                 "C=32768)", SR_SRC,
                 "graphblas_tpu/kernels/sortreduce.py:252"),
    "K6@32768": ("sort_reduce_cluster_regs_kernel + tokens "
                 "(sort_reduce_rows_tok, C=32768)", SR_SRC,
                 "graphblas_tpu/kernels/sortreduce.py:465"),
    "K7@32768": ("sort_reduce_cluster_regs_kernel, pair counts "
                 "(sort_reduce_pair1, C=32768)", SR_SRC,
                 "graphblas_tpu/kernels/sortreduce.py:360"),
    "K8@32768": ("sort_reduce_cluster_regs_kernel + key2 "
                 "(sort_reduce_rows_wide, C=32768)", SR_SRC,
                 "graphblas_tpu/kernels/sortreduce.py:435"),
    "K9": ("permute_gather_32 (global_permute, tile_permute, "
           "sublane_permute)", PERMUTE_SRC,
           "graphblas_tpu/kernels/static_route.py:580"),
}
BIG_C = 32768
SMALL_CAPS = (128, 512, 2048, 8192)
BLOCK_KERNEL = "sort_reduce_block_regs_kernel"
CLUSTER_KERNEL = "sort_reduce_cluster_regs_kernel"
OFF_PATH = ("K7@32768", "K8@32768")   # checked and timed, not in "kernels"
SR_WRAPPERS = {"K5": "sort_reduce_rows", "K6": "sort_reduce_rows_tok",
               "K7": "sort_reduce_pair1", "K8": "sort_reduce_rows_wide"}
UNIFORM_CNNZ = 268_406_919   # the compiled SuiteSparse's answers
UNIFORM_NTRI = 647           # (BENCH_ALL.json, bench_real.py)
RMAT18_NTRI = 19_595_360
RMAT18_CNNZ = 1_278_009_346


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_ptxas(log, name):
    """ptxas's report (-Xptxas -v) of every instance of the kernel
    ``name``: a list of (registers, spill store bytes, spill load bytes,
    static shared-memory bytes)."""
    out, cur, spill = [], False, (0, 0)
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = name in ln
        elif cur and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          ln)
            spill = (int(m[1]), int(m[2]))
        elif cur and "registers" in ln:
            sm = re.search(r"(\d+) bytes smem", ln)
            out.append((int(re.search(r"Used (\d+) registers", ln)[1]),
                        *spill, int(sm[1]) if sm else 0))
            cur = False
    return out


def max_err(got, want, add, tol):
    """max|got - want| after checking the stated tolerance (exact for
    min/max, inf entries included)."""
    g = got.double().cpu().numpy()
    w = want.double().cpu().numpy()
    if add in ("min", "max"):
        assert np.array_equal(g, w), f"{add}: kernel != plain"
        return 0.0
    err = float(np.abs(g - w).max(initial=0.0))
    bound = tol * float(np.abs(w).max(initial=0.0))
    assert err <= bound, f"err {err} > {bound}"
    return err


def time_ms(fn, reps=20, warm=3):
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def small_csr(rng, dtype):
    import scipy.sparse as sps
    m, n = 5000, 200_000
    deg = rng.integers(0, 24, m)
    deg[::13] = 0                                   # empty rows
    rows = np.repeat(np.arange(m), deg)
    cols = rng.integers(0, n, rows.size)
    hub = rng.choice(n, 100_000, replace=False)     # one 10^5-nonzero row
    rows = np.concatenate([rows, np.full(hub.size, 17)])
    cols = np.concatenate([cols, hub])
    S = sps.csr_matrix((rng.standard_normal(rows.size).astype(dtype),
                        (rows, cols)), shape=(m, n))
    S.sum_duplicates()
    return S


def csr_cuda(S, dtype=None):
    import torch
    v = S.data if dtype is None else S.data.astype(dtype)
    return (torch.from_numpy(S.indptr.astype(np.int32)).cuda(),
            torch.from_numpy(S.indices.astype(np.int32)).cuda(),
            torch.from_numpy(np.ascontiguousarray(v)).cuda())


def phase_kernels(errs):
    """Phase 3: each instantiation vs its plain version on the card."""
    import torch
    from graphblas_tpu_torch import testing as GT
    from graphblas_tpu_torch.kernels import spmv_onehot as OH
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    rng = np.random.default_rng(11)
    n_cmp = 0
    for dt in (np.float32, np.float64):
        S = small_csr(rng, dt)
        ip, ix, v = csr_cuda(S)
        x = torch.from_numpy(rng.standard_normal(S.shape[1]).astype(dt)
                             ).cuda()
        p = SPR.build_plan(ip, ix, v, S.shape)
        if dt == np.float64:
            got = SPR.spmv_route_ds(x, p)
            want = SPR.spmv_planned_plain(x, p, "plus", "times")
            torch.cuda.synchronize()
            errs["K4"] = max(errs["K4"], max_err(got, want, "plus",
                                                 FP64_TOL))
            n_cmp += 1
            continue
        # misaligned operands: both arrays one element past a 16-byte
        # boundary (16-byte loads after a head), then the indices alone
        # (4-byte loads); row starts fall at every offset mod 4
        for si, sv in ((0, 0), (1, 1), (1, 0)):
            ixs, vs = GT.shifted(ix, si), GT.shifted(v, sv)
            got = OH.spmv(ip, ixs, vs, x, S.shape[0])
            want = OH.spmv_plain(ip, ixs, vs, x, S.shape[0])
            torch.cuda.synchronize()
            errs["K2"] = max(errs["K2"], max_err(got, want, "plus",
                                                 FP32_TOL))
            n_cmp += 1
            if si:
                ps = SPR.build_plan(ip, ixs, vs, S.shape)
                got = SPR.spmv_route(x, ps)
                want = SPR.spmv_planned_plain(x, ps, "plus", "times")
                torch.cuda.synchronize()
                errs["K1"] = max(errs["K1"], max_err(got, want, "plus",
                                                     FP32_TOL))
                n_cmp += 1
        for add in ADDS:
            for mul in MULS:
                if (add, mul) == ("plus", "times"):
                    got, key = SPR.spmv_route(x, p), "K1"
                else:
                    got = SPR.spmv_route_monoid(x, p, add=add, mul=mul)
                    key = "K3"
                want = SPR.spmv_planned_plain(x, p, add, mul)
                torch.cuda.synchronize()
                errs[key] = max(errs[key],
                                max_err(got, want, add, FP32_TOL))
                n_cmp += 1
    return n_cmp, S.shape, int(np.diff(S.indptr).max())


def uniform_graph(n, deg, seed):
    """bench.py's generator: n vertices, n*deg uniform random edges from
    default_rng(seed), duplicates merged, pattern values."""
    import scipy.sparse as sps
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, n * deg).astype(np.int32)
    cols = rng.integers(0, n, n * deg).astype(np.int32)
    S = sps.csr_matrix((np.ones(n * deg, np.float32), (rows, cols)),
                       shape=(n, n))
    S.sum_duplicates()
    S.data[:] = 1.0
    return S


def bench_graph():
    """bench.py's graph: n = 2^20, degree 16, seed 0 (pattern values)."""
    return uniform_graph(1 << 20, 16, 0)


def rmat_graph(scale=20):
    """bench_real.py's power-law graph: RMAT at ``scale``, edge factor 16,
    seed 7 (pattern values), from the port's copy of its generator."""
    import scipy.sparse as sps
    from graphblas_tpu_torch.testing import rmat_edges
    ri, ci, n = rmat_edges(scale, 16, np.random.default_rng(7))
    S = sps.csr_matrix((np.ones(ri.size, np.float32), (ri, ci)),
                       shape=(n, n))
    S.sum_duplicates()
    S.data[:] = 1.0
    return S


def relerr(got, want):
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-30))


def pagerank_ref(S, steps=20, damping=0.85):
    """fp64 numpy power iteration on the pattern, same update as the
    port's PageRank."""
    n = S.shape[0]
    deg = np.diff(S.indptr).astype(np.float64)
    sdeg = np.where(deg > 0, deg, 1.0)
    St = S.T.tocsr().astype(np.float64)
    r = np.full(n, 1.0 / n)
    for _ in range(steps):
        rn = St @ (r / sdeg)
        r = damping * (rn + r[deg == 0].sum() / n) + (1.0 - damping) / n
    return r


def main_path(label, S, rng):
    """Phase 4 on one graph; returns the plans/arrays phase 6 times."""
    import scipy.sparse.csgraph as csg
    import torch

    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch.algorithms import graph as G
    from graphblas_tpu_torch.core import ops as OPS
    from graphblas_tpu_torch.core import semiring as SR
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    from graphblas_tpu_torch.ops.mxm import spmv_arrays
    t0 = time.perf_counter()
    n = S.shape[0]
    nnz = S.nnz
    S64 = S.astype(np.float64)
    x = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    ref = S64 @ x.astype(np.float64)
    A = gt.Matrix.from_scipy(S, device="cuda")
    u = gt.Vector.from_dense(torch.from_numpy(x).cuda())
    checks = {}
    # K2: plus-times mxv, no plan
    y = gt.mxv(A, u, SR.PLUS_TIMES).to_dense_1d()[0].cpu().numpy()
    checks["mxv"] = relerr(y, ref)
    # K1: planned mxv with a value mask and accum PLUS
    Ao = A.optimize()
    c = rng.standard_normal(n).astype(np.float32)
    mv = (rng.random(n) < 0.5).astype(np.float32)
    C = gt.Vector.from_dense(torch.from_numpy(c).cuda())
    Mk = gt.Vector.from_dense(torch.from_numpy(mv).cuda())
    y1 = gt.mxv(Ao, u, SR.PLUS_TIMES, C=C, mask=Mk, accum=OPS.PLUS)
    has = np.diff(S.indptr) > 0
    want1 = np.where((mv != 0) & has, c + ref, c)
    checks["mxv_plan_mask_accum"] = relerr(
        y1.to_dense_1d()[0].cpu().numpy(), want1)
    # K4: fp64 planned SpMV on the fp64 CSR arrays
    v64 = Ao.values.double()
    SPR.plan_for(Ao.indptr, Ao.indices, v64, Ao.shape)
    x64 = torch.from_numpy(x.astype(np.float64)).cuda()
    y64 = spmv_arrays(Ao.indptr, Ao.indices, v64, x64, n).cpu().numpy()
    checks["spmv_fp64"] = relerr(y64, ref)
    assert checks["spmv_fp64"] <= FP64_TOL * 10, checks
    # K3: vxm MIN_PLUS through a plan on A's CSC arrays (= A' by row)
    Ac = A.to_format(gt.SPARSE, gt.COL)
    Ac.T.optimize()
    z = gt.vxm(u, Ac, SR.MIN_PLUS)
    zv, zp = (t.cpu().numpy() for t in z.to_dense_1d())
    Sc = S.tocsc()
    nonempty = np.diff(Sc.indptr) > 0
    prod = x[Sc.indices] + Sc.data
    zref = np.minimum.reduceat(prod, Sc.indptr[:-1][nonempty])
    assert np.array_equal(zp, nonempty) and np.array_equal(zv[zp], zref), \
        "vxm MIN_PLUS"
    # CSC conversion
    assert np.array_equal(Ac.indptr.cpu().numpy(), Sc.indptr) and \
        np.array_equal(Ac.indices.cpu().numpy(), Sc.indices), "to CSC"
    # PageRank, fused (planned, fp32) and GrB tier (fp64)
    pr_ref = pagerank_ref(S)
    r, it = G.pagerank_fused(A, optimize=True, max_iter=20, tol=0.0)
    checks["pagerank_fused"] = relerr(r.cpu().numpy(), pr_ref)
    r2 = G.pagerank(A, max_iter=20, tol=0.0).to_dense_1d()[0]
    checks["pagerank"] = relerr(r2.cpu().numpy(), pr_ref)
    # BFS, fused (planned) and GrB tier, vs scipy levels
    src = 0 if S.indptr[1] > 0 else int(np.argmax(np.diff(S.indptr)))
    lref = csg.dijkstra(S, indices=src, unweighted=True)
    reach = np.isfinite(lref)
    lf = G.bfs_levels_fused(A, src, optimize=True).cpu().numpy()
    assert np.array_equal(lf >= 0, reach) and \
        np.array_equal(lf[reach], lref[reach].astype(np.int32)), "bfs fused"
    lv, lp = (t.cpu().numpy() for t in G.bfs_levels(A, src).to_dense_1d())
    assert np.array_equal(lp, reach) and \
        np.array_equal(lv[reach], lref[reach].astype(np.int32)), "bfs"
    # SSSP with integer weights 1..100, vs Dijkstra (exact)
    W = S.copy()
    W.data = rng.integers(1, 101, nnz).astype(np.float32)
    Aw = gt.Matrix.from_scipy(W, device="cuda")
    d = G.sssp(Aw, src, optimize=True).cpu().numpy()
    dref = csg.dijkstra(W, indices=src)
    assert np.array_equal(d, dref), "sssp"
    torch.cuda.synchronize()
    for k in ("mxv", "mxv_plan_mask_accum", "spmv_fp64", "pagerank_fused",
              "pagerank"):
        assert checks[k] <= RELERR_GUARD, (k, checks[k])
    print(f"[4 main path {label}] n={n} nnz={nnz} "
          f"max_row={int(np.diff(S.indptr).max())} src={src} "
          f"bfs_reached={int(reach.sum())} "
          f"depth={int(lref[reach].max())} pr_iters={it} "
          + " ".join(f"{k}={v:.3e}" for k, v in checks.items())
          + f" vxm_min_plus=exact bfs=exact sssp=exact "
          f"wall_s={time.perf_counter() - t0:.1f}", flush=True)
    p32 = SPR.plan_for(Ao.indptr, Ao.indices, Ao.values, Ao.shape,
                       build=False)
    p64 = SPR.plan_for(Ao.indptr, Ao.indices, v64, Ao.shape, build=False)
    return dict(A=Ao, x=x, p32=p32, p64=p64)


def bound(nbytes, ops):
    """(least ms, what bounds it): bytes at the HBM rate against
    operations at the fp32 (non-tensor-core) rate."""
    tb, to = nbytes / HBM_BYTES_S, ops / FP32_OPS_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def spmv_bound(m, n, nnz, vbytes):
    """y = A x: each input read once (indptr, indices, values, x), y
    written once; 2 operations per nonzero."""
    return bound(4 * (m + 1) + nnz * (4 + vbytes) + vbytes * (n + m),
                 2 * nnz)


def phase_times(label, st, card, errs):
    """Phase 6: each kernel, its plain version and (K1, K2, K4) one torch
    sparse CSR product at one graph."""
    import torch
    from graphblas_tpu_torch.kernels import spmv_onehot as OH
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    A, p32, p64 = st["A"], st["p32"], st["p64"]
    ip, ix, v = A.indptr, A.indices, A.values
    m = A.nrows
    nnz = int(ix.shape[0])
    x = torch.from_numpy(st["x"]).cuda()
    x64 = x.double()
    csr32 = torch.sparse_csr_tensor(ip.long(), ix.long(), v, A.shape)
    csr64 = torch.sparse_csr_tensor(ip.long(), ix.long(), v.double(),
                                    A.shape)

    plain = SPR.spmv_planned_plain
    runs = {
        "K2": (lambda: OH.spmv(ip, ix, v, x, m),
               lambda: OH.spmv_plain(ip, ix, v, x, m), "plus", FP32_TOL,
               lambda: csr32 @ x, 4),
        "K1": (lambda: SPR.spmv_route(x, p32),
               lambda: plain(x, p32, "plus", "times"), "plus", FP32_TOL,
               lambda: csr32 @ x, 4),
        "K3": (lambda: SPR.spmv_route_monoid(x, p32, add="min", mul="plus"),
               lambda: plain(x, p32, "min", "plus"), "min", FP32_TOL, None,
               4),
        "K4": (lambda: SPR.spmv_route_ds(x64, p64),
               lambda: plain(x64, p64, "plus", "times"), "plus", FP64_TOL,
               lambda: csr64 @ x64, 8),
    }
    out = {}
    for key, (kern, ref, add, tol, libf, vb) in runs.items():
        got, want = kern(), ref()
        torch.cuda.synchronize()
        errs[key] = max(errs[key], max_err(got, want, add, tol))
        # turns: plain, kernel, kernel, plain; keep the medians' means
        tp1 = time_ms(ref)
        tk1 = time_ms(kern)
        tk2 = time_ms(kern)
        tp2 = time_ms(ref)
        tl = time_ms(libf) if libf is not None else None
        out[key] = ((tk1 + tk2) / 2, (tp1 + tp2) / 2, tl,
                    *spmv_bound(m, A.ncols, nnz, vb))
    print(f"[6 times {label}] {card} | nnz={nnz} | " + " | ".join(
        f"{KERNELS[k][0]}: {t:.3f} ms ({nnz / t / 1e6:.2f} Gnnz/s), plain "
        f"{tp:.3f} ms, torch.sparse "
        + ("-" if tl is None else f"{tl:.3f} ms") + f", bound {b:.4f} ms"
        for k, (t, tp, tl, b, _) in out.items()), flush=True)
    split = {k: two_passes(runs[k][0]) for k in ("K2", "K1")}
    print(f"[6 passes {label}] {card} | device time a call, "
          "torch.profiler, 20 calls | " + " | ".join(
              f"{KERNELS[k][0]}: merge-path kernel "
              f"{s['spmv_merge_kernel']:.1f} us + carry pass "
              f"{s['spmv_carry_kernel']:.1f} us"
              for k, s in split.items()), flush=True)
    return out


def gather_wall(st, card):
    """Phase 6 at graph (a): what binds the SpMV kernels.  K1's merge-path
    kernel (device time) on graph (a)'s rows and values, with its columns
    as they are, then redrawn uniformly in [0, 2^16) (x's 256 KB stay in
    L2 but not in L1) and in [0, 2^13) (32 KB: the gathers hit L1).  The
    same bytes come from device memory in all three."""
    import torch
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    A = st["A"]
    x = torch.from_numpy(st["x"]).cuda()
    rng = np.random.default_rng(17)
    us = {}
    for label, hi in (("graph columns", None), ("columns < 2^16", 1 << 16),
                      ("columns < 2^13", 1 << 13)):
        ix = A.indices if hi is None else torch.from_numpy(
            rng.integers(0, hi, A.nvals).astype(np.int32)).cuda()
        p = SPR.build_plan(A.indptr, ix, A.values, A.shape)
        us[label] = two_passes(
            lambda: SPR.spmv_route(x, p))["spmv_merge_kernel"]
    print(f"[6 gather wall] {card} | {KERNELS['K1'][0]} merge-path kernel, "
          "device time a call: " + " | ".join(
              f"{k} {v:.1f} us" for k, v in us.items()), flush=True)


def two_passes(fn, calls=20):
    """The device time (us) of each of the SpMV's two kernels in one call
    of ``fn``, by name, under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        for name in ("spmv_merge_kernel", "spmv_carry_kernel"):
            if name in e.key and _on_device(e):
                us[name] = us.get(name, 0.0) + _dev_us(e) / calls
    assert set(us) == {"spmv_merge_kernel", "spmv_carry_kernel"}, us
    return us


# ---------------------------------------------------------------------------
# sort-reduce kernels K5-K8
# ---------------------------------------------------------------------------

def phase_sr_kernels(errs):
    """Phase 3b: K5-K8 against their plain versions on the card at every
    C, on random runs and on the layouts' edge runs (aligned and one
    element past a 16-byte boundary), each call twice and bitwise equal.
    The launch counts are set to 0 before; returns (comparisons, launches
    by (wrapper, C))."""
    import torch
    from graphblas_tpu_torch import testing as GT
    from graphblas_tpu_torch.kernels import sortreduce as SRD
    rng = np.random.default_rng(12)
    cu = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    n_cmp = 0

    def check(key, fn, plain, args, kw, exact):
        nonlocal n_cmp
        got, again = fn(*args, **kw), fn(*args, **kw)
        torch.cuda.synchronize()
        errs[key] = max(errs[key], GT.sr_err(got, plain(*args, **kw),
                                             exact))
        same = all(torch.equal(a, b) for a, b in zip(got, again)) \
            if isinstance(got, tuple) else torch.equal(got, again)
        assert same, f"{key} not bitwise repeatable"
        n_cmp += 1

    SRD.reset_launches()
    for C in SMALL_CAPS + (BIG_C,):
        big = "@32768" if C == BIG_C else ""
        for edge, by in ((False, 0), (True, 0), (True, 1)):
            on = lambda a: GT.shifted(cu(a), by)  # noqa: E731
            for key, fn, plain, args, kw, exact in GT.sr_cases(rng, C, edge,
                                                               on):
                check(key + big, fn, plain, args, kw, exact)
    return n_cmp, dict(SRD.launches_by_cap)


def phase_permute_kernel(errs):
    """Phase 3c: K9 against its plain version on a random permutation of
    2^24 + 777 fp32 elements (exact)."""
    import torch
    from graphblas_tpu_torch.kernels import static_route as STR
    rng = np.random.default_rng(14)
    n = (1 << 24) + 777
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).cuda()
    plan = STR.GlobalPermutePlan(torch.from_numpy(rng.permutation(n))
                                 .cuda(), n)
    got = STR.global_permute(x, plan)
    torch.cuda.synchronize()
    assert torch.equal(got, STR.permute_plain(x, plan.perm)), "K9"
    errs["K9"] = max(errs["K9"], 0.0)
    return n


def phase_repeat(S):
    """Phase 3d: the SpMV at graph (b) is bitwise repeatable (rows cut
    between tiles fold their carries without atomics): two K2 calls, two
    K1 calls, two K3 min-plus calls.  Returns (tiles, tiles whose end cuts
    a row)."""
    import torch
    from graphblas_tpu_torch.kernels import spmv_onehot as OH
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    ip, ix, v = csr_cuda(S)
    p = SPR.build_plan(ip, ix, v, S.shape)
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(
        S.shape[1]).astype(np.float32)).cuda()
    m = S.shape[0]
    e, f = OH.spmv(ip, ix, v, x, m), OH.spmv(ip, ix, v, x, m)
    a, b = SPR.spmv_route(x, p), SPR.spmv_route(x, p)
    c = SPR.spmv_route_monoid(x, p, add="min", mul="plus")
    d = SPR.spmv_route_monoid(x, p, add="min", mul="plus")
    torch.cuda.synchronize()
    assert torch.equal(e, f), "K2 not bitwise repeatable"
    assert torch.equal(a, b), "K1 not bitwise repeatable"
    assert torch.equal(c, d), "K3 min-plus not bitwise repeatable"
    tr = p.tile_row.cpu().numpy().astype(np.int64)
    yk = np.arange(p.ntiles) * SPR._cuda.SPMV_TILE - tr[:-1]  # nonzeros
    cuts = int((S.indptr[tr[1:-1]] < yk[1:]).sum())
    return p.ntiles, cuts


class Recorder:
    """Records the first call of each sort-reduce wrapper during a path
    (``first``; its inputs are the shapes phase 8 times), for C in
    ``caps`` its first call at that C (``by_cap[(key, C)]``), and the C of
    every call in order (``seq``); the call itself goes to the wrapper,
    which counts its own launches."""

    def __init__(self, caps=()):
        from graphblas_tpu_torch.kernels import sortreduce as SRD
        self.SRD = SRD
        self.caps = caps
        self.first = {}
        self.by_cap = {}
        self.seq = []
        self.orig = {}

    def __enter__(self):
        for key, name in SR_WRAPPERS.items():
            fn = getattr(self.SRD, name)
            self.orig[name] = fn
            setattr(self.SRD, name, self._wrap(key, fn))
        return self

    def _wrap(self, key, fn):
        def call(*args, **kw):
            C = next(a for a in args if isinstance(a, int))
            self.first.setdefault(key, (args, kw))
            self.seq.append(C)
            if C in self.caps:
                self.by_cap.setdefault((key, C), (args, kw))
            return fn(*args, **kw)
        return call

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.SRD, name, fn)


def csr_rows(C, rows):
    """Rows ``rows`` (sorted) of a port CSR matrix on the card, as scipy."""
    import scipy.sparse as sps
    import torch
    ip = C.indptr.cpu().numpy().astype(np.int64)
    lo, hi = ip[rows], ip[rows + 1]
    pos = torch.from_numpy(np.concatenate(
        [np.arange(a, b) for a, b in zip(lo, hi)])).cuda()
    return sps.csr_matrix(
        (C.values[pos].cpu().numpy(), C.indices[pos].cpu().numpy(),
         np.concatenate([[0], np.cumsum(hi - lo)])),
        shape=(rows.size, C.ncols))


def assert_rows(C, want, rows, what):
    """Sampled rows of C equal scipy's ``want`` exactly (pattern, order,
    values)."""
    got = csr_rows(C, rows)
    want = want.tocsr()
    want.eliminate_zeros()
    want.sort_indices()
    assert np.array_equal(got.indptr, want.indptr), f"{what}: row counts"
    assert np.array_equal(got.indices, want.indices), f"{what}: columns"
    assert np.array_equal(got.data, want.data.astype(got.data.dtype)), \
        f"{what}: values"


def timed(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def spgemm_path(rng):
    """Phase 7: the SpGEMM main path at full size; returns (wall times,
    fallback rows at RMAT-18)."""
    import scipy.sparse as sps
    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch.core import semiring as SR
    from graphblas_tpu_torch.core import types as T
    t0 = time.perf_counter()
    wall = {}
    # (a) bench.py's uniform graph: C = A*A (K5)
    S = bench_graph()
    n = S.shape[0]
    A = gt.Matrix.from_scipy(S, device="cuda")
    C, wall["spgemm_a_cold"] = timed(lambda: gt.mxm(A, A, SR.PLUS_TIMES))
    csum = check_product(C, S, rng, UNIFORM_CNNZ, "A*A")
    del C
    C, wall["spgemm_a_warm"] = timed(lambda: gt.mxm(A, A, SR.PLUS_TIMES))
    assert C.nvals == UNIFORM_CNNZ
    del C
    # complemented structural mask: C<!A> = A*A (K6, want_token False)
    d = gt.Descriptor(mask_structure=True, mask_complement=True)
    Cc = gt.mxm(A, A, SR.PLUS_TIMES, mask=A, desc=d)
    rows = np.sort(rng.choice(n, 4096, replace=False))
    Sr = S[rows]
    full = Sr @ S
    assert_rows(Cc, full - full.multiply(Sr != 0), rows, "A*A<!A>")
    del Cc
    # triangle count (K7) and the materialised masked count (K6)
    ntri, wall["tc_a_cold"] = timed(lambda: gt.triangle_count(A))
    assert ntri == UNIFORM_NTRI, ntri
    ntri, wall["tc_a_warm"] = timed(lambda: gt.triangle_count(A))
    assert ntri == UNIFORM_NTRI, ntri
    L = sps.tril(S, -1).tocsr()
    assert int((L @ L.T).multiply(L).sum()) == UNIFORM_NTRI
    Lt = gt.select(A, gt.operators.TRIL, -1)
    LT = Lt.T.to_format(gt.SPARSE, gt.ROW)
    Cm = gt.mxm(Lt, LT, SR.PLUS_PAIR, mask=Lt,
                desc=gt.Descriptor(mask_structure=True), out_dtype=T.INT64)
    assert Cm.dtype == T.INT64 and int(Cm.values.sum()) == UNIFORM_NTRI
    print(f"[7 spgemm a] n={n} nnz={S.nnz} cnnz={UNIFORM_CNNZ} "
          f"sampled_rows=4096 exact checksum={csum:.0f} "
          f"complement=exact ntri={ntri} masked_count="
          f"{int(Cm.values.sum())} scipy_ntri=match", flush=True)
    del Cm, Lt, LT, A
    # (b) RMAT-18 triangle count (hub rows take the classic fallback)
    S18 = rmat_graph(18)
    n18 = S18.shape[0]
    A18 = gt.Matrix.from_scipy(S18, device="cuda")
    msgs = []
    gt.set_option("printf", msgs.append)
    gt.set_option("burble", True)
    ntri18, wall["tc_b_cold"] = timed(lambda: gt.triangle_count(A18))
    gt.set_option("burble", False)
    fb = [m for m in msgs if "fallback rows" in m]
    assert ntri18 == RMAT18_NTRI, ntri18
    ntri18, wall["tc_b_warm"] = timed(lambda: gt.triangle_count(A18))
    assert ntri18 == RMAT18_NTRI, ntri18
    print(f"[7 spgemm b] RMAT-18 n={n18} nnz={S18.nnz} ntri={ntri18} | "
          + "; ".join(fb), flush=True)
    del A18
    # (c) wide keys: n = 2^23 columns, degree 2 (K8)
    Sw = uniform_graph(1 << 23, 2, 0)
    Aw = gt.Matrix.from_scipy(Sw, device="cuda")
    rows = np.sort(rng.choice(Sw.shape[0], 4096, replace=False))
    Swr = Sw[rows]
    Cw = gt.mxm(Aw, Aw, SR.PLUS_TIMES)
    assert_rows(Cw, Swr @ Sw, rows, "wide A*A")
    cw = Cw.nvals
    del Cw
    Cwm = gt.mxm(Aw, Aw, SR.PLUS_TIMES, mask=Aw,
                 desc=gt.Descriptor(mask_structure=True))
    assert_rows(Cwm, (Swr @ Sw).multiply(Swr != 0), rows, "wide A*A<A>")
    print(f"[7 spgemm c] wide n={Sw.shape[0]} nnz={Sw.nnz} cnnz={cw} "
          f"masked_cnnz={Cwm.nvals} sampled_rows=exact "
          f"wall_s={time.perf_counter() - t0:.1f}", flush=True)
    return wall


def check_product(C, S, rng, cnnz, what):
    """C = S*S on a pattern S: the compiled SuiteSparse's nnz, 4096
    sampled rows exact against scipy, and the fp64 sum of C equal to
    (S'1).(S1); returns the sum."""
    import torch
    n = S.shape[0]
    assert C.nvals == cnnz, (what, C.nvals, cnnz)
    rows = np.sort(rng.choice(n, 4096, replace=False))
    assert_rows(C, S[rows] @ S, rows, what)
    csum = float(C.values.sum(dtype=torch.float64))
    ones = np.ones(n)
    want = float((S.T @ ones) @ (S @ ones))
    assert csum == want, (what, csum, want)
    return csum


def with_burble(fn):
    """fn() with burble on: (its result, its spgemm-fast lines and the
    lines of SELL's decline)."""
    import graphblas_tpu_torch as gt
    msgs = []
    gt.set_option("printf", msgs.append)
    gt.set_option("burble", True)
    try:
        out = fn()
    finally:
        gt.set_option("burble", False)
    return out, [m[5:] for m in msgs
                 if "spgemm-fast:" in m or "SELL declined" in m
                 or "slot domain beyond" in m]


def csr_keys(M):
    """row * ncols + column of every entry of a port CSR matrix on the
    card (int64, ascending for sorted rows)."""
    import torch
    ip = M.indptr.long()
    k = torch.repeat_interleave(
        torch.arange(M.nrows, device=ip.device), ip.diff(),
        output_size=int(M.indices.numel()))
    return k.mul_(M.ncols).add_(M.indices)


def assert_restriction(Cm, C, A):
    """Cm equals C restricted to A's pattern: the same entries, the same
    values (bitwise), compared on the card."""
    import torch
    ck = csr_keys(C)
    ak = csr_keys(A)
    pos = torch.searchsorted(ck, ak).clamp_(max=ck.numel() - 1)
    hit = ck[pos] == ak
    del ck
    assert torch.equal(csr_keys(Cm), ak[hit]), "C<A> pattern"
    assert torch.equal(Cm.values, C.values[pos[hit]]), "C<A> values"


def fast_tier_path(rng, card):
    """Phase 11: the fast SpGEMM tier at full size.  RMAT-18's A*A has
    2.9e9 products, a slot domain beyond SELL's int32 limit, so SELL
    declines it and the fast tier computes it, as in the JAX package.
    The sort-reduce launch counts are set to 0 before and read after.
    C = A*A: nnz against the compiled SuiteSparse's answer, 4096 sampled
    rows exact against scipy, fp64 checksum; C<A> = A*A (structural mask,
    K6): equal on the card to A*A restricted to A's pattern, and 4096
    sampled rows exact.  Then one warm A*A traced.  Returns (wall times,
    recorder, launches by (wrapper, C))."""
    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch.core import semiring as SR
    from graphblas_tpu_torch.kernels import sortreduce as SRD
    wall = {}
    S18 = rmat_graph(18)
    n18 = S18.shape[0]
    A18 = gt.Matrix.from_scipy(S18, device="cuda")
    d = gt.Descriptor(mask_structure=True)
    mxm = lambda: gt.mxm(A18, A18, SR.PLUS_TIMES)  # noqa: E731
    masked = lambda: gt.mxm(A18, A18, SR.PLUS_TIMES, mask=A18,  # noqa
                            desc=d)
    SRD.reset_launches()
    with Recorder(caps=(BIG_C,)) as rec:
        (C, lines), wall["fast_spgemm_b_cold"] = timed(
            lambda: with_burble(mxm))
        assert any("SELL declined" in ln for ln in lines), lines
        csum = check_product(C, S18, rng, RMAT18_CNNZ, "fast A*A RMAT-18")
        print(f"[11 fast tier] RMAT-18 A*A n={n18} nnz={S18.nnz} "
              f"cnnz={RMAT18_CNNZ} sampled_rows=4096 exact checksum="
              f"{csum:.0f} | " + "; ".join(lines), flush=True)
        (Cm, lines), wall["fast_masked_b_cold"] = timed(
            lambda: with_burble(masked))
        assert any("SELL declined" in ln for ln in lines), lines
        assert_restriction(Cm, C, A18)
        rows = np.sort(rng.choice(n18, 4096, replace=False))
        Sr = S18[rows]
        assert_rows(Cm, (Sr @ S18).multiply(Sr != 0), rows,
                    "fast A*A<A> RMAT-18")
        cmnz = Cm.nvals
        print(f"[11 fast tier] RMAT-18 C<A> = A*A cnnz={cmnz} = A*A on A's "
              f"pattern (exact) sampled_rows=4096 exact | "
              + "; ".join(lines), flush=True)
        del C, Cm
        C, wall["fast_spgemm_b_warm"] = timed(mxm)
        assert C.nvals == RMAT18_CNNZ
        del C
        Cm, wall["fast_masked_b_warm"] = timed(masked)
        assert Cm.nvals == cmnz
        del Cm
    counts = dict(SRD.launches_by_cap)
    print("[11 launches] " + ", ".join(
        f"{name}@C={c}: {v}" for (name, c), v in sorted(counts.items()))
        + f" | {card} | wall " + " ".join(
            f"{k}_s={v:.3f}" for k, v in wall.items()), flush=True)
    for c in SRD.CAPS:
        assert counts.get(("sort_reduce_rows", c), 0) > 0, (c, counts)
    assert counts.get(("sort_reduce_rows_tok", BIG_C), 0) > 0, counts
    traced("fast A*A RMAT-18", mxm, card, FAST_PHASES, "11 trace")
    return wall, rec, counts


def phase_permute(card, errs):
    """Phase 13: K9 through ``global_permute`` on graph (a)'s CSR -> CSC
    value permutation, the launch count set to 0 before and read after:
    exact against the plain version and scipy's CSC values; times beside
    the bound (12 B an element) and one torch.take."""
    import scipy.sparse as sps
    import torch
    from graphblas_tpu_torch.kernels import static_route as STR
    S = bench_graph()
    nnz = S.nnz
    P = sps.csr_matrix((np.arange(nnz, dtype=np.int64), S.indices,
                        S.indptr), shape=S.shape).tocsc()
    xv = np.random.default_rng(16).standard_normal(nnz).astype(np.float32)
    x = torch.from_numpy(xv).cuda()
    plan = STR.GlobalPermutePlan(torch.from_numpy(P.data).cuda(), nnz)
    STR.launches = 0
    got = STR.global_permute(x, plan)
    torch.cuda.synchronize()
    launches = STR.launches
    assert launches > 0
    want = sps.csr_matrix((xv, S.indices, S.indptr), shape=S.shape) \
        .tocsc().data
    assert np.array_equal(got.cpu().numpy(), want), "K9 vs scipy CSC"
    assert torch.equal(got, STR.permute_plain(x, plan.perm)), "K9 vs plain"
    errs["K9"] = max(errs["K9"], 0.0)
    perm64 = plan.perm.long()
    kern = lambda: STR.global_permute(x, plan)  # noqa: E731
    ref = lambda: STR.permute_plain(x, plan.perm)  # noqa: E731
    tp1, tk1, tk2, tp2 = time_ms(ref), time_ms(kern), time_ms(kern), \
        time_ms(ref)
    tl = time_ms(lambda: torch.take(x, perm64))
    out = ((tk1 + tk2) / 2, (tp1 + tp2) / 2, tl, *bound(12 * nnz, 0))
    print(f"[13 permute] {card} | {KERNELS['K9'][0]}: {out[0]:.3f} ms on "
          f"{nnz} elements (graph (a) CSR -> CSC), plain {out[1]:.3f} ms, "
          f"torch.take {tl:.3f} ms, bound {out[3]:.4f} ms ({out[4]}); "
          f"launches {launches}; exact vs plain and scipy", flush=True)
    return launches, out


SR_BYTES = {"K5": 16, "K6": 20, "K7": 8}   # per slot; K8 below


def phase_sr_times(calls, card, errs, tag="8 sort-reduce times"):
    """Phase 8 (and 12): sort-reduce kernels and their plain versions on
    the inputs ``calls`` ({key: (args, kw)}; key K5..K8, or K5@32768 ...
    K8@32768), beside the bound of their bytes and one torch.sort of the
    same runs' keys (a yardstick: a sort alone, not the function)."""
    import torch
    from graphblas_tpu_torch import testing as GT
    from graphblas_tpu_torch.kernels import sortreduce as SRD
    plains = {"K5": SRD.sort_reduce_rows_plain,
              "K6": SRD.sort_reduce_rows_tok_plain,
              "K7": SRD.sort_reduce_pair1_plain,
              "K8": SRD.sort_reduce_rows_wide_plain}
    out = {}
    for key, (args, kw) in calls.items():
        base = key.split("@")[0]
        name = SR_WRAPPERS[base]
        kern = lambda: getattr(SRD, name)(*args, **kw)  # noqa: E731
        ref = lambda: plains[base](*args, **kw)  # noqa: E731
        C = next(a for a in args if isinstance(a, int))
        vals = None if base == "K7" else args[2 if base == "K8" else 1]
        exact = vals is None or not (vals.dtype == torch.float32
                                     and args[-1].op.name == "GrB_PLUS")
        errs[key] = max(errs[key], GT.sr_err(kern(), ref(), exact))
        slots = args[0].numel()
        per = SR_BYTES.get(base) or (28 if kw.get("toks") is not None
                                     else 24)
        tp1 = time_ms(ref, reps=5)
        tk1 = time_ms(kern)
        tk2 = time_ms(kern)
        tp2 = time_ms(ref, reps=5)
        ts = time_ms(lambda: torch.sort(args[0].view(-1, C), dim=1))
        # operations: a comparison sort needs log2(C) per slot, the
        # reduce one more
        # (ms, plain ms, library ms: no single torch call, bound, by)
        out[key] = ((tk1 + tk2) / 2, (tp1 + tp2) / 2, None,
                    *bound(slots * per, slots * (C.bit_length())))
        print(f"[{tag}] {card} | {key} {KERNELS[key][0]}: "
              f"{out[key][0]:.3f} ms on {slots} slots (C={C}, "
              f"{slots / out[key][0] / 1e6:.2f} Gslot/s), plain "
              f"{out[key][1]:.3f} ms, bound {out[key][3]:.4f} ms "
              f"({out[key][4]}); torch.sort of the keys' runs {ts:.3f} ms",
              flush=True)
    return out


def big_k7_k8_calls(rng):
    """K7 and K8 at C = 32768 (no main path runs them) on 140 runs, the
    size of the fast tier's first block at that C: {key: (args, kw)}."""
    import torch
    from graphblas_tpu_torch import testing as GT
    from graphblas_tpu_torch.core import monoid as TM
    cu = lambda a: torch.from_numpy(a).cuda()  # noqa: E731
    kh, kl, tw = GT.sr_wide_keys(rng, BIG_C, runs=140)
    vals = cu(GT.sr_values(rng, kh.size, "f32"))
    return {f"K7@{BIG_C}": ((cu(GT.sr_pair1_keys(rng, BIG_C, runs=140)),
                             BIG_C), {}),
            f"K8@{BIG_C}": ((cu(kh), cu(kl), vals, BIG_C, TM.PLUS),
                            {"toks": cu(tw)})}


def phase_resources(calls, card):
    """Phase 12: each sort-reduce kernel's resources on this card (blocks
    an SM holds at once, or clusters the card holds, registers, spills,
    shared memory) by what rides the sort and C, and one torch.sort of
    the K5 inputs' runs at 32768."""
    import torch
    from graphblas_tpu_torch.kernels import _cuda
    keys = calls[f"K5@{BIG_C}"][0][0]
    ts = time_ms(lambda: torch.sort(keys.view(-1, BIG_C), dim=1))
    parts = []
    for mode in _cuda.SR_MODES:
        for C in (2048, 8192, BIG_C):
            v = _cuda.sort_reduce_info(mode, C)
            unit = "blocks/SM" if C < BIG_C else "clusters"
            parts.append(
                f"{mode}@{C}: {v['resident']} {unit}, {v['registers']} "
                f"regs, {v['local_bytes']} B local, smem "
                f"{v['static_smem']} + {v['dynamic_smem']} B")
    print(f"[12 resources] {card} | " + " | ".join(parts)
          + f" | torch.sort(keys.view(-1, {BIG_C}), dim=1) {ts:.3f} ms on "
          f"the K5@{BIG_C} inputs (sort only, not the function)", flush=True)


SPGEMM_PHASES = {"spgemm_sell": ("_prep", "_pass1", "_counts", "_pass2"),
                 "mxm": ("_spgemm_block",)}
# the fast tier: whole blocks, within them the expansion + sort-reduce of
# each class and the classic ESC (expansion, sort-reduce) of the rows over
# the top class; the rest of a block is placement and row counts
FAST_PHASES = {"spgemm_fast": ("_block", "_class_sort"),
               "mxm": ("_spgemm_expand_at", "_spgemm_block")}


def _dev_us(e):
    """A profiler event's own device time in us."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def _on_device(e):
    """The device's own events (kernels, copies, sets).  Operator events
    (aten::*) may also carry the device type and report their kernels'
    time again, so they are left out."""
    from torch.autograd import DeviceType
    return e.device_type == DeviceType.CUDA and not e.key.startswith(
        "aten::")


def _busy_s(events):
    """Seconds in which the device ran anything: the union of its own
    events' time ranges (overlapping kernels count once)."""
    busy, end = 0.0, float("-inf")
    for t0, t1 in sorted((e.time_range.start, e.time_range.end)
                         for e in events):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    return busy / 1e6


def traced(label, fn, card, phases=SPGEMM_PHASES, tag="10 trace"):
    """One warm call of ``fn`` with its SpGEMM phases (``phases``) timed
    on the host (each wrapped in synchronize), then one under
    torch.profiler: device busy time against wall time, where the device
    time goes (by operator and by kernel, each its own time), and the
    sort-reduce kernels' device time by C (each launch matched to the C
    of its wrapper call, in launch order).  Returns the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from graphblas_tpu_torch.ops import mxm as M
    from graphblas_tpu_torch.ops import spgemm_fast as SGF
    from graphblas_tpu_torch.ops import spgemm_sell as SGS
    mods = {"spgemm_sell": SGS, "spgemm_fast": SGF, "mxm": M}
    spent = {}
    orig = {}

    def wrap(name, f):
        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **k)
            torch.cuda.synchronize()
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    for mod, names in phases.items():
        for name in names:
            orig[(mod, name)] = getattr(mods[mod], name)
            setattr(mods[mod], name, wrap(name, orig[(mod, name)]))
    _, wall = timed(fn)
    for (mod, name), f in orig.items():
        setattr(mods[mod], name, f)
    with Recorder() as rec, profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) \
            as prof:
        _, wall_p = timed(fn)
    ev = prof.key_averages()
    launched = sorted((e for e in prof.events() if _on_device(e)
                       and "_regs_kernel" in e.name),
                      key=lambda e: e.time_range.start)
    assert len(launched) == len(rec.seq), (len(launched), len(rec.seq))
    by_c = {}
    for e, C in zip(launched, rec.seq):
        ms, n = by_c.get(C, (0.0, 0))
        by_c[C] = (ms + (e.time_range.end - e.time_range.start) / 1e3,
                   n + 1)
    kern = sorted((e for e in ev if _on_device(e) and _dev_us(e) > 0),
                  key=lambda e: -_dev_us(e))
    busy = _busy_s([e for e in prof.events() if _on_device(e)])
    assert 0 < busy <= wall_p, (busy, wall_p)
    ops = sorted((e for e in ev if e.key.startswith("aten::")),
                 key=lambda e: -_dev_us(e))
    top_ops = ", ".join(f"{e.key} {_dev_us(e) / 1e3:.1f} ms x{e.count}"
                        for e in ops[:6])
    top_k = ", ".join(f"{e.key[:48]} {_dev_us(e) / 1e3:.1f} ms x{e.count}"
                      for e in kern[:6])
    # the sort-reduce kernels (K5-K8), wherever they rank, and by C
    srk = ", ".join(
        f"{e.key.replace('(anonymous namespace)::', '').split('(')[0]} "
        f"{_dev_us(e) / 1e3:.1f} ms x{e.count}" for e in kern
        if "_regs_kernel" in e.key)
    srk += "; by C: " + ", ".join(
        f"C={C} {ms:.1f} ms x{n}" for C, (ms, n) in sorted(by_c.items()))
    small = [v for C, v in by_c.items() if C < BIG_C]
    srk += (f"; C <= 8192 together {sum(m for m, _ in small):.1f} ms "
            f"x{sum(n for _, n in small)}")
    print(f"[{tag} {label}] {card} | wall {wall:.3f} s; host-timed "
          f"phases " + " ".join(f"{k}={v:.3f}s" for k, v in spent.items())
          + f" | profiled wall {wall_p:.3f} s, device busy {busy:.3f} s "
          f"(idle {1 - busy / wall_p:.1%}) | device time by operator: "
          f"{top_ops} | by kernel: {top_k} | sort-reduce kernels: {srk}",
          flush=True)
    return 1 - busy / wall_p


def phase_trace(card):
    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch.core import semiring as SR
    S = bench_graph()
    A = gt.Matrix.from_scipy(S, device="cuda")
    gt.mxm(A, A, SR.PLUS_TIMES)                     # warm: prep cached
    traced("A*A uniform 2^20", lambda: gt.mxm(A, A, SR.PLUS_TIMES), card)
    del A
    A18 = gt.Matrix.from_scipy(rmat_graph(18), device="cuda")
    gt.triangle_count(A18)                          # warm: L, L' cached
    traced("triangle_count RMAT-18", lambda: gt.triangle_count(A18), card)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import graphblas_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the graphblas_tpu_torch package is not beside "
              f"this script ({e})", file=sys.stderr)
        return 2
    # 1. device
    card = card_line()
    print(f"[1 device] {card} | {torch.cuda.get_device_name(0)} | "
          f"count={torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    # 2. build
    from graphblas_tpu_torch.kernels import _cuda
    t0 = time.perf_counter()
    libs = _cuda.build()
    for name in libs:
        _cuda.lib(name)
    regs = [ln.strip() for name in libs
            for ln in _cuda.build_log(name).splitlines() if "registers" in ln]
    print(f"[2 build] {time.perf_counter() - t0:.1f} s -> "
          f"{', '.join(p.name for p in libs.values())}; "
          f"ptxas: {len(regs)} kernels, "
          f"{max((ln for ln in regs), key=len, default='')}", flush=True)
    for kname in (BLOCK_KERNEL, CLUSTER_KERNEL):
        cp = kernel_ptxas(_cuda.build_log("sortreduce"), kname)
        assert cp, f"no ptxas report of {kname}"
        print(f"[2 build] ptxas {kname}: {len(cp)} instances, "
              f"registers {min(c[0] for c in cp)}-{max(c[0] for c in cp)}, "
              f"spill stores <= {max(c[1] for c in cp)} B, spill loads <= "
              f"{max(c[2] for c in cp)} B, static shared memory "
              f"{max(c[3] for c in cp)} B", flush=True)
    # 3. kernels vs plain versions
    graphs = {"a (bench.py uniform 2^20 x16)": bench_graph(),
              "b (RMAT-20 x16)": rmat_graph()}
    errs = {k: 0.0 for k in KERNELS}
    t0 = time.perf_counter()
    n_cmp, shape, max_row = phase_kernels(errs)
    n_sr, sr_launches = phase_sr_kernels(errs)
    n_perm = phase_permute_kernel(errs)
    n_tiles, n_cuts = phase_repeat(graphs["b (RMAT-20 x16)"])
    print(f"[3 kernels] {n_cmp} SpMV instantiations match their plain "
          f"versions (min/max exact, fp32 plus <= {FP32_TOL}*max|y|, fp64 "
          f"<= {FP64_TOL}*max|y|) at {shape[0]}x{shape[1]}, max row "
          f"{max_row}; {n_sr} sort-reduce comparisons of K5-K8 at C = "
          f"{', '.join(map(str, SMALL_CAPS + (BIG_C,)))} (random runs and "
          f"edge runs aligned and one element past a 16-byte boundary, "
          f"each call twice bitwise equal; keys, ints, bool, min/max and "
          f"K7 exact, fp32 plus <= {FP32_TOL}*max|v|; launches "
          + ", ".join(f"{n}@{c}={v}" for (n, c), v in
                      sorted(sr_launches.items()))
          + f"); K9 exact on {n_perm} "
          f"elements; K2, K1 and K3 min-plus bitwise repeatable at graph "
          f"(b) ({n_tiles} tiles, {n_cuts} of them start inside a row); "
          f"max|err| " + ", ".join(
              f"{k}={v:.3e}" for k, v in errs.items())
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    # 4. main path; 5. launch counts
    from graphblas_tpu_torch.kernels import sortreduce as SRD
    from graphblas_tpu_torch.kernels import spmv_onehot as OH
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    from graphblas_tpu_torch.utils import native as NAT
    rng = np.random.default_rng(3)
    OH.launches = 0
    for k in SPR.launches:
        SPR.launches[k] = 0
    states = {label: main_path(label, S, rng) for label, S in graphs.items()}
    counts = {"K2": OH.launches, "K1": SPR.launches["spmv_route"],
              "K3": SPR.launches["spmv_route_monoid"],
              "K4": SPR.launches["spmv_route_ds"]}
    print("[5 launches] " + ", ".join(
        f"{KERNELS[k][0]}={v}" for k, v in counts.items()), flush=True)
    assert all(v > 0 for v in counts.values()), counts
    # 6. times
    times = {label: phase_times(label, st, card, errs)
             for label, st in states.items()}
    gather_wall(states[next(iter(states))], card)
    ta = times[next(iter(times))]
    del states, times, graphs
    # 7. SpGEMM main path, sort-reduce launch counts
    SRD.reset_launches()
    for k in NAT.sweeps:
        NAT.sweeps[k] = 0
    with Recorder() as rec:
        wall = spgemm_path(rng)
    for key, name in SR_WRAPPERS.items():
        counts[key] = SRD.launches[name]
    print("[7 launches] " + ", ".join(
        f"{KERNELS[k][0]}={counts[k]}" for k in SR_WRAPPERS)
        + " | by C: " + ", ".join(
            f"{n}@{c}={v}" for (n, c), v in
            sorted(SRD.launches_by_cap.items()))
        + f"; layout sweeps {NAT.sweeps}", flush=True)
    assert all(counts[k] > 0 for k in SR_WRAPPERS), counts
    assert NAT.sweeps["python"] == 0, NAT.sweeps
    # 8. sort-reduce times
    ta.update(phase_sr_times(rec.first, card, errs))
    del rec
    # 9. wall times; 10. where the SpGEMM time goes
    print(f"[9 wall] {card} | " + " ".join(
        f"{k}_s={v:.3f}" for k, v in wall.items()), flush=True)
    phase_trace(card)
    # 11. the fast tier at full size; 12. the C = 32768 kernels' times
    # (K5/K6 on the fast tier's first inputs at that C, K7/K8 on inputs of
    # that size: no path runs them at 32768)
    _, rec, by_cap = fast_tier_path(rng, card)
    for key in ("K5", "K6"):
        counts[f"{key}@{BIG_C}"] = by_cap[(SR_WRAPPERS[key], BIG_C)]
    big = {f"{k}@{BIG_C}": rec.by_cap[(k, BIG_C)] for k in ("K5", "K6")}
    big.update(big_k7_k8_calls(rng))
    ta.update(phase_sr_times(big, card, errs, "12 sort-reduce times C=32768"))
    phase_resources(big, card)
    del rec, big
    # 13. K9
    counts["K9"], ta["K9"] = phase_permute(card, errs)
    # result lines
    print(card_line())
    print(json.dumps({"kernels": [
        {"name": KERNELS[k][0], "route": "cuda", "source": KERNELS[k][1],
         "replaces": KERNELS[k][2], "launches": counts[k],
         "max_abs_err": errs[k], "ms": ta[k][0], "plain_ms": ta[k][1],
         "bound_ms": ta[k][3], "bound_by": ta[k][4],
         "library_ms": ta[k][2]}
        for k in KERNELS if k not in OFF_PATH]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
