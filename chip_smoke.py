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
     random permutation of 2^24 + 777 fp32 elements (exact), two K2,
     two K1 and two K3 min-plus calls at graph (b) bitwise equal, and KP
     (the SpMV plan's tiling, through spmv_route.build_plan) bit for bit
     against the host tiling _tile_rows at testing.TILING_EDGES and at
     the skewed CSR above;
  4. SpMV main path at real size through the public API on two graphs —
     (a) bench.py's uniform graph (n = 2^20, degree 16, seed 0) and
     (b) RMAT scale 20, edge factor 16, seed 7 (bench_real.py's graph,
     from the port's copy of its generator), a power-law graph — with
     mxv/vxm (unplanned, planned with mask + accum, min-plus), the fp64
     planned SpMV, CSC conversion, PageRank, BFS and SSSP, each checked
     against scipy/numpy on the host; then the warm A.to_format(SPARSE,
     COL) (its row ids and values through one K9 launch): wall, one call
     traced (idle share, device time by kernel, K9's share), and K9 with
     both payloads against the former two library gathers;
  5. launch counts: every SpMV kernel, K9 and KP launched during phase
     4's checks (K9: the reorients of the CSC conversion, the fused
     PageRank, BFS and SSSP and vxm; KP: each plan built);
  6. SpMV times: each kernel, its plain version and one torch.sparse CSR
     product (K1, K2, K4) at graphs (a) and (b) (CUDA events, median of
     20 after warm-up) beside the bound of its bytes, and K1's and K2's
     two passes (the merge-path kernel, the carry pass) apart, by their
     device time under torch.profiler; at graph (a) also K1's kernel with
     the columns redrawn in [0, 2^16) and [0, 2^13) (x in L2 only, x in
     L1: what the x gather costs); KP at the benchmark's scale-24 row
     pointers (urand and Kronecker degrees, made on the card) and at
     RMAT-18, bit for bit against _tile_rows and timed beside its bound,
     the host tiling and one torch.searchsorted (the kernels line's KP
     entry is urand-24's);
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
 13. K9 on graph (a)'s CSR -> CSC permutation: global_permute of fp32
     and fp64 values through a checked plan, exact against the plain
     version and scipy's CSC values, and the reorient's call (int32 row
     ids and the values, the int64 order), exact and bitwise repeatable;
     each timed beside its bound, the plain version and torch.take;
 14. eWise, pending events, unsigned arithmetic and the GrB-tier
     algorithms at graph (b), weights 1..255 from a seed, each exact
     against scipy/numpy on the host: ewise_add PLUS, ewise_mult TIMES,
     ewise_union MINUS of A and A' (gt.transpose), and ewise_add under a
     structural mask; ewise_add PLUS and MIN and ewise_mult LT and DIV of
     the same pattern as UINT64, w where w is even and 2^64 - w where it
     is odd (PLUS wraps; MIN, LT and DIV order values across 2^63); the
     dense path on a BITMAP and a SPARSE vector of 2^24; 100,000
     set_element calls (half on stored entries, repeats) and 20,000
     remove_element calls (some on entries queued before) on a copy of A,
     then wait(), against the events applied in order; bfs_parents from
     the vertex of highest out-degree (each parent an in-neighbour one
     level up, the reached set scipy's), connected_components (scipy's
     weak components, least-vertex labels) and sssp_grb (Dijkstra); each
     step's wall cold and warm, one warm ewise_add under torch.profiler
     with the device idle share, and the K1-K9 and KP launches during the phase
     (K9 through the reorients of gt.transpose and the GrB-tier
     algorithms; no other kernel lies on this path);
 15. the rest of the op layer and the operator sugar at graph (b),
     weights 1..255 from a seed, each step through gt.* and exact against
     scipy/numpy on the host: extract (the sentinel-sort and compact
     branches, 2^16 repeated indices on the sparse repeat path, a masked
     and accumulated extract), subassign C(I,J)<M> += A(I2,J2), assign
     under a global mask, C(I,J) = x, C<M> = 0 on the sparse-mask fast
     path (16 M mask entries holding explicit false), the sugar A[I, J],
     A[M], A[M] = x, A + A.T, 2 * A and A @ v (K2), kron of RMAT-14 with
     a 64-vertex seed graph against scipy.sparse.kron, split / concat
     (bitwise A), diag / vector_diag, resize / reshape, sort by LT and GT
     (INT8 holding -128 and UINT64 across 2^63 too), gauss-integer struct
     values (build with a user dup, eWise, reduce), serialize /
     deserialize (none, zlib, gbz) and from_mtx (an RMAT-16 file); each
     step's wall cold and warm, one warm extract and one warm subassign
     traced, the K1-K9 and KP launches during the phase;
 16. the distributed tier (graphblas_tpu_torch.parallel) on a
     world-size-1 NCCL group in this process: at graph (b) from_matrix,
     dist_mxv plus-times fp32 before the shard has a plan (bitwise K2 on
     the whole CSR), min-plus (K3, exact), fp64 (K4, 1e-12 * max|y|),
     with mask + accum and a complemented mask, dist_vxm (1e-5 * max|y|
     of scipy), dist_reduce_scalar, dist_bfs_levels from the hub (exact),
     dist_pagerank 20 steps (1e-4), the 1x1 dist_mxv_2d (bitwise K2) and
     a save_sharded / load_sharded round trip; at graph (a) dist_mxm A*A
     (SELL, K5: cnnz 268,406,919, sampled rows exact); then
     dryrun_multichip(1), one spawned NCCL rank.  Walls cold and warm, a
     warm dist_mxv and dist_pagerank traced (idle share, NCCL kernels'
     device time), the K1-K9 and KP launches during the phase (K2-K5 > 0);
 17. the last public surface: each demo of graphblas_tpu_torch.examples
     (bfs, context, gauss, kron, semiring, serialize) through its
     main(device="cuda") at its own sizes, against scipy/numpy; at graph
     (b), weights 1..8 from seed 17: GxB_BF16 ewise_add PLUS of A and A'
     (31,400,481 entries, exact), mxv PLUS_TIMES with x = 1 (each row the
     float64 sum rounded once to bf16), reduce_scalar (within one bf16
     ulp), apply AINV and a serialize round trip (bitwise); the LSE_PLUS
     mxv (1e-5 relative of numpy's logaddexp) and the clip01 apply of
     semiring_demo in fp32; context_demo's four threads, an fp32 mxv
     each under its own Context (K2 4 times; bitwise equal to one K2
     call); pack / unpack (bitwise); kron_demo's seed to 10 factors
     (59,049 vertices, 9,765,625 entries, exact against scipy.sparse.kron);
     gauss_demo's struct semiring through mxm at uniform n = 2^16,
     degree 8 (exact against scipy's complex128 product).  Each step's
     wall cold and warm and the K1-K9 and KP launches of its cold call.
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
    "K9": ("gb_permute_gather (permute_rows: the CSR <-> CSC reorient's "
           "row ids + values; global_permute, tile_permute, "
           "sublane_permute)", PERMUTE_SRC,
           "graphblas_tpu/kernels/static_route.py:580"),
    "KP": ("spmv_partition_kernel (the SpMV plan's merge-path tiling, "
           "spmv_route.build_plan)", SPMV_SRC,
           "none: the plan's host tiling, spmv_route._tile_rows"),
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
    from graphblas_tpu_torch.kernels import static_route as STR
    from graphblas_tpu_torch.ops.mxm import spmv_arrays
    t0 = time.perf_counter()
    k9_before = STR.launches
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
    k9 = STR.launches - k9_before
    for k in ("mxv", "mxv_plan_mask_accum", "spmv_fp64", "pagerank_fused",
              "pagerank"):
        assert checks[k] <= RELERR_GUARD, (k, checks[k])
    print(f"[4 main path {label}] n={n} nnz={nnz} "
          f"max_row={int(np.diff(S.indptr).max())} src={src} "
          f"bfs_reached={int(reach.sum())} "
          f"depth={int(lref[reach].max())} pr_iters={it} "
          + " ".join(f"{k}={v:.3e}" for k, v in checks.items())
          + f" vxm_min_plus=exact bfs=exact sssp=exact "
          f"K9 launches {k9} wall_s={time.perf_counter() - t0:.1f}",
          flush=True)
    reorient_times(label, A)
    p32 = SPR.plan_for(Ao.indptr, Ao.indices, Ao.values, Ao.shape,
                       build=False)
    p64 = SPR.plan_for(Ao.indptr, Ao.indices, v64, Ao.shape, build=False)
    return dict(A=Ao, x=x, p32=p32, p64=p64, k9=k9)


def reorient_times(label, A):
    """Phase 4: the warm A.to_format(SPARSE, COL) of the main path's
    matrix: its wall (host clock, median of 5 after 2 warm-up calls, in
    turns with the same steps on two library gathers, vecid[order] and
    types.take(values, order), whose arrays it equals), one call traced
    (device busy and idle share, device time by kernel, K9's share), and
    the gathers alone: K9 with both payloads against the two library
    gathers on the same order, CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch.core import types as T
    from graphblas_tpu_torch.kernels import segment as K
    from graphblas_tpu_torch.kernels import static_route as STR
    conv = lambda: A.to_format(gt.SPARSE, gt.COL)  # noqa: E731

    def before():
        """The reorient as it ran before K9 served it: the same steps with
        two library gathers (the yardstick)."""
        vecid = K.expand_rowids(A.indptr, A.nvals, A.nrows)
        sidx, order = torch.sort(A.indices, stable=True)
        return (K.indptr_from_sorted(sidx, A.ncols, torch.int32),
                vecid[order].to(torch.int32),
                T.take(A._vals_expanded(), order))

    C = conv()
    assert all(torch.equal(a, b) for a, b in zip(
        (C.indptr, C.indices, C.values), before())), "reorient"

    def wall_ms(fn):
        return float(np.median([timed(fn)[1] for _ in range(7)][2:])) * 1e3
    w1, b1, b2, w2 = (wall_ms(f) for f in (conv, before, before, conv))
    wall, wall_before = (w1 + w2) / 2, (b1 + b2) / 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_p = timed(conv)
    busy = _busy_s([e for e in prof.events() if _on_device(e)])
    by_k = {}
    for e in prof.key_averages():
        if _on_device(e) and _dev_us(e) > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.split("(")[0].split("<")[0][:40]
            by_k[name] = by_k.get(name, 0.0) + _dev_us(e) / 1e3
    k9_ms = sum(v for k, v in by_k.items() if any(
        t in k for t in ("permute_gather_kernel", "pack_kernel",
                         "gather_pairs_kernel", "demote_lines")))
    vecid = K.expand_rowids(A.indptr, A.nvals, A.nrows)
    order = torch.sort(A.indices, stable=True)[1]
    vals = A._vals_expanded().contiguous()
    fused = lambda: STR.permute_rows(vecid, order, vals)  # noqa: E731
    lib = lambda: (vecid[order], T.take(vals, order))  # noqa: E731
    tl1, tk1, tk2, tl2 = (time_ms(f) for f in (lib, fused, fused, lib))
    print(f"[4 reorient {label}] {card_line()} | to_format(SPARSE, COL) of "
          f"{A.nvals} entries ({A.dtype.name}{' iso' if A.iso else ''}) "
          f"warm wall {wall:.3f} ms (median of 5, two rounds), with the "
          f"two library gathers instead {wall_before:.3f} ms | traced wall "
          f"{wall_p * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms (idle "
          f"{1 - busy / wall_p:.1%}), K9 {k9_ms:.3f} ms "
          f"({k9_ms / (busy * 1e3):.1%} of busy); by kernel: " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in sorted(
                  by_k.items(), key=lambda kv: -kv[1])[:6])
          + f" | the gathers: K9 two payloads {(tk1 + tk2) / 2:.3f} ms, "
          f"library vecid[order] + types.take {(tl1 + tl2) / 2:.3f} ms",
          flush=True)


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


def scale24_indptrs():
    """The row pointers of the benchmark's scale-24 graphs as the card's
    plan build sees them, made on the card: 2^24 vertices, 16 * 2^24
    edges counted at both ends (undirected), duplicates and self loops
    kept.  "urand-24": both ends uniform (GAP's urand); "kron-24": each
    end's vertex bit set with probability 0.24 a level (the Graph500
    initiator's c + d = b + d), then the vertices permuted."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(24)
    n, ends = 1 << 24, 2 * 16 << 24

    def indptr(v):
        deg = torch.bincount(v, minlength=n)
        return torch.cat([deg.new_zeros(1), deg.cumsum(0)]).int()
    out = {"urand-24": indptr(torch.randint(n, (ends,), generator=gen,
                                            device="cuda"))}
    v = torch.zeros(ends, dtype=torch.int64, device="cuda")
    for level in range(24):
        v |= (torch.rand(ends, generator=gen, device="cuda") < 0.24
              ).long() << level
    out["kron-24"] = indptr(torch.randperm(n, generator=gen,
                                           device="cuda")[v])
    return out


def partition_times(card, errs):
    """Phase 6: KP at the benchmark's scale-24 shapes and at RMAT-18
    (testing.tiling_indptr), each checked bit for bit against
    ``_tile_rows`` through ``build_plan``, then timed: the kernel (CUDA
    events, 20 launches an event pair, median of 20), the host tiling it
    replaced (``_tile_rows`` on the fetched indptr, host clock, median of
    3), one torch.searchsorted of the row ends (the same answer from a
    library call) and the bound of its bytes (a 32-byte sector of indptr
    read and 4 B written a boundary).  Returns the kernels line's entry,
    at urand-24."""
    import torch
    from graphblas_tpu_torch import testing as GT
    from graphblas_tpu_torch.kernels import _cuda
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    tile = _cuda.SPMV_TILE
    shapes = scale24_indptrs()
    shapes["rmat-18"] = torch.from_numpy(GT.tiling_indptr(
        "rmat18", tile, np.random.default_rng(18))).cuda()
    out, lines = {}, []
    for label, ipt in shapes.items():
        ip = ipt.cpu().numpy()
        m, nnz = ip.size - 1, int(ip[-1])
        errs["KP"] = max(errs["KP"], partition_mismatch(ipt, ip))
        assert errs["KP"] == 0, ("KP", label, errs["KP"])
        tiles = _cuda.spmv_tiles(m, nnz)
        tr = torch.empty(tiles + 1, dtype=torch.int32, device="cuda")
        steps = torch.arange(tiles + 1, device="cuda").mul_(tile)
        steps.clamp_(max=m + nnz)

        def kern():
            for _ in range(20):
                _cuda.spmv_partition(ipt, tr, nnz)

        def lib():
            ends = ipt[1:].long() + torch.arange(m, device="cuda")
            return torch.searchsorted(ends, steps)
        kern()
        want = torch.from_numpy(SPR._tile_rows(ip)).cuda()
        assert torch.equal(tr, want) and torch.equal(lib().int(), want), \
            ("KP", label)
        t = time_ms(kern) / 20
        t_lib = time_ms(lib)
        t_host = float(np.median([timed(lambda: SPR._tile_rows(ip))[1]
                                  for _ in range(3)])) * 1e3
        b, by = bound((tiles + 1) * (32 + 4), 0)
        out[label] = (t, t_host, t_lib, b, by)
        lines.append(f"{label} m={m} nnz={nnz} boundaries={tiles + 1}: "
                     f"{t:.5f} ms, host _tile_rows {t_host:.3f} ms, "
                     f"torch.searchsorted {t_lib:.4f} ms, bound {b:.6f} ms")
    print(f"[6 partition] {card} | {KERNELS['KP'][0]}, bitwise equal to "
          "_tile_rows | " + " | ".join(lines), flush=True)
    return out["urand-24"]


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


def phase_partition_kernel(errs):
    """Phase 3e: KP through ``spmv_route.build_plan`` on the card against
    ``_tile_rows`` (bit for bit) at the tiling's edges
    (``testing.TILING_EDGES``) and at phase 3's skewed CSR.  Returns the
    cases."""
    import torch
    from graphblas_tpu_torch import testing as GT
    from graphblas_tpu_torch.kernels import _cuda
    rng = np.random.default_rng(16)
    ips = {c: GT.tiling_indptr(c, _cuda.SPMV_TILE, rng)
           for c in GT.TILING_EDGES}
    ips["skewed"] = small_csr(rng, np.float32).indptr.astype(np.int32)
    for case, ip in ips.items():
        errs["KP"] = max(errs["KP"], partition_mismatch(
            torch.from_numpy(ip).cuda(), ip))
    assert errs["KP"] == 0, ("KP", errs["KP"])
    return len(ips)


def partition_mismatch(ipt, ip):
    """Entries of the card's tiling of ``ipt`` (a build_plan's tile_row)
    that differ from ``_tile_rows(ip)``, its host copy."""
    import torch
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    nnz = int(ip[-1])
    p = SPR.build_plan(ipt, torch.empty(nnz, dtype=torch.int32,
                                        device="cuda"),
                       torch.empty(nnz, device="cuda"), (ip.size - 1, 1))
    got = p.tile_row.cpu().numpy()
    want = SPR._tile_rows(ip)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.count_nonzero(got != want))


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
    """Phase 13: K9 on graph (a)'s CSR -> CSC permutation, the launch
    count set to 0 before and read after: through ``global_permute``'s
    checked plan (fp32 and fp64 values) exact against the plain version
    and scipy's CSC values, and through the call the reorient makes
    (``permute_rows`` with the int32 row ids and fp32 or fp64 values, the
    int64 order of a stable sort) exact against the plain version,
    bitwise again on a second call; each timed beside the bound of its
    bytes, the plain version and one torch.take a payload.  Returns
    (launches, the times of the reorient's call with fp32 values for the
    kernels line)."""
    import scipy.sparse as sps
    import torch
    from graphblas_tpu_torch.core import types as T
    from graphblas_tpu_torch.kernels import static_route as STR
    S = bench_graph()
    nnz = S.nnz
    P = sps.csr_matrix((np.arange(nnz, dtype=np.int64), S.indices,
                        S.indptr), shape=S.shape).tocsc()
    rng = np.random.default_rng(16)
    plan = STR.GlobalPermutePlan(torch.from_numpy(P.data).cuda(), nnz)
    order = plan.perm.long()
    vecid = torch.from_numpy(np.repeat(np.arange(S.shape[0], dtype=np.int32),
                                       np.diff(S.indptr))).cuda()
    STR.launches = 0
    out, lines = None, []
    for dt in (np.float32, np.float64):
        xv = rng.standard_normal(nnz).astype(dt)
        x = torch.from_numpy(xv).cuda()
        got = STR.global_permute(x, plan)
        gi, gx = STR.permute_rows(vecid, order, x)
        gi2, gx2 = STR.permute_rows(vecid, order, x)
        torch.cuda.synchronize()
        want = sps.csr_matrix((xv, S.indices, S.indptr), shape=S.shape) \
            .tocsc().data
        assert np.array_equal(got.cpu().numpy(), want), "K9 vs scipy CSC"
        assert torch.equal(got, STR.permute_plain(x, plan.perm)), "K9"
        assert torch.equal(gx, got) and torch.equal(gx2, gx), "K9 two"
        assert torch.equal(gi, vecid[order]) and torch.equal(gi2, gi), \
            "K9 row ids"
        errs["K9"] = max(errs["K9"], 0.0)
        w = x.element_size()
        runs = {
            "one payload (global_permute through a plan, int32 perm)": (
                lambda x=x: STR.global_permute(x, plan),
                lambda x=x: STR.permute_plain(x, plan.perm),
                lambda x=x: torch.take(x, order), nnz * (4 + 2 * w)),
            "reorient's call, two payloads (row ids + values, int64 "
            "order)": (
                lambda x=x: STR.permute_rows(vecid, order, x),
                lambda x=x: STR.permute_plain(vecid, order, x),
                lambda x=x: (torch.take(vecid, order), torch.take(x, order)),
                nnz * (8 + 2 * (4 + w)))}
        for what, (kern, ref, libf, nb) in runs.items():
            tp1, tk1, tk2, tp2 = (time_ms(f) for f in (ref, kern, kern, ref))
            tl = time_ms(libf)
            t = ((tk1 + tk2) / 2, (tp1 + tp2) / 2, tl, *bound(nb, 0))
            lines.append(f"{np.dtype(dt).name} {what}: {t[0]:.3f} ms, plain "
                         f"{t[1]:.3f} ms, torch.take {t[2]:.3f} ms, bound "
                         f"{t[3]:.4f} ms ({t[4]})")
            if out is None and what.startswith("reorient"):
                out = t
    launches = STR.launches
    assert launches > 0
    print(f"[13 permute] {card} | {KERNELS['K9'][0]} on {nnz} elements "
          f"(graph (a) CSR -> CSC; two payloads packed into one row) | "
          + " | ".join(lines)
          + f" | launches {launches}; exact vs plain and scipy, "
          f"bitwise repeatable", flush=True)
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


# ---------------------------------------------------------------------------
# 14. eWise, pending tuples, unsigned arithmetic and the GrB-tier algorithms
# ---------------------------------------------------------------------------

def kernel_launches():
    """K1-K9 and KP launch counts as the wrappers keep them."""
    from graphblas_tpu_torch.kernels import sortreduce as SRD
    from graphblas_tpu_torch.kernels import spmv_onehot as OH
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    from graphblas_tpu_torch.kernels import static_route as STR
    out = {"K1": SPR.launches["spmv_route"], "K2": OH.launches,
           "K3": SPR.launches["spmv_route_monoid"],
           "K4": SPR.launches["spmv_route_ds"], "K9": STR.launches,
           "KP": SPR.launches["spmv_partition"]}
    out.update({k: SRD.launches[n] for k, n in SR_WRAPPERS.items()})
    return dict(sorted(out.items()))


def reset_kernel_launches():
    from graphblas_tpu_torch.kernels import sortreduce as SRD
    from graphblas_tpu_torch.kernels import spmv_onehot as OH
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    from graphblas_tpu_torch.kernels import static_route as STR
    OH.launches = 0
    STR.launches = 0
    for k in SPR.launches:
        SPR.launches[k] = 0
    SRD.reset_launches()


def host_entries(M):
    """(row-major keys, values) of a port matrix, on the host."""
    import graphblas_tpu_torch as gt
    R = M.to_format(gt.SPARSE, gt.ROW)
    return csr_keys(R).cpu().numpy(), gt.types.host(R._vals_expanded())


def csr_host_keys(S):
    """row * ncols + column of every entry of a scipy CSR matrix (int64,
    ascending when its indices are sorted)."""
    return np.repeat(np.arange(S.shape[0], dtype=np.int64),
                     np.diff(S.indptr)) * S.shape[1] + S.indices


def union_ref(W, Wt):
    """Host union of two CSR matrices whose values are integers 1..255:
    (keys, a, b), a and b 0 where absent.  One scipy sum W + 1000 Wt
    (a linear merge, no sort) carries both values, a + 1000 b."""
    E = (W.astype(np.int64) + 1000 * Wt.astype(np.int64)).tocsr()
    E.sort_indices()
    return csr_host_keys(E), E.data % 1000, E.data // 1000


def assert_entries(M, keys, vals, what):
    got_k, got_v = host_entries(M)
    assert np.array_equal(got_k, keys), f"{what}: pattern"
    assert got_v.dtype == vals.dtype and np.array_equal(got_v, vals), \
        f"{what}: values"


def two_walls(fn):
    """(result, cold wall, warm wall): the first call and a second one."""
    out, cold = timed(fn)
    del out
    out, warm = timed(fn)
    return out, cold, warm


def ewise_path(S, card):
    """Phase 14 at graph (b): eWise add/mult/union of A and A' (a
    structural mask too), the same as UINT64 on both sides of 2^63 (PLUS,
    MIN, LT, DIV), the dense path on
    two vectors of 2^24, 100,000 set_element and 20,000 remove_element
    calls and wait(), and bfs_parents, connected_components and sssp_grb,
    each held against scipy/numpy on the host (exact); walls cold and
    warm, one warm ewise_add traced, K1-K9 and KP launches during the phase."""
    import scipy.sparse as sps
    import scipy.sparse.csgraph as csg
    import torch
    from torch.profiler import ProfilerActivity, profile

    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch import testing as GT
    ops, T = gt.operators, gt.types
    t_phase = time.perf_counter()
    rng = np.random.default_rng(14)
    n = S.shape[0]
    W = S.copy()
    W.data = rng.integers(1, 256, W.nnz).astype(np.float32)
    Wt = W.T.tocsr()
    A = gt.Matrix.from_scipy(W, device="cuda")
    At = gt.transpose(A)                       # A' by column, logically
    ka = csr_host_keys(W)
    u, a, b = union_ref(W, Wt)
    ha, hb = a > 0, b > 0
    a, b = a.astype(np.float32), b.astype(np.float32)
    walls, parts = {}, {}
    t_part = [t_phase]

    def part(name):
        """Seconds since the last part ended: where the phase's time
        goes, host references included."""
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    part("setup")
    reset_kernel_launches()
    # eWise on fp32 integer weights (exact)
    steps = {
        "ewise_add_plus": (lambda: gt.ewise_add(A, At, ops.PLUS),
                           u, a + b),
        "ewise_mult_times": (lambda: gt.ewise_mult(A, At, ops.TIMES),
                             u[ha & hb], (a * b)[ha & hb]),
        "ewise_union_minus": (lambda: gt.ewise_union(A, 300, At, 7,
                                                     ops.MINUS),
                              u, np.where(ha, a, 300) - np.where(hb, b, 7)),
        "ewise_add_masked": (lambda: gt.ewise_add(
            A, At, ops.PLUS, mask=A, desc=gt.Descriptor(
                mask_structure=True)), u[ha], (a + b)[ha]),
    }
    for name, (fn, keys, vals) in steps.items():
        C, walls[name + "_cold"], walls[name + "_warm"] = two_walls(fn)
        assert_entries(C, keys, vals.astype(np.float32), name)
        del C
    part("ewise_fp32")
    # the same pattern as UINT64 on both sides of 2^63: w where w is even,
    # 2^64 - w where it is odd.  PLUS wraps; MIN, LT and DIV must order
    # and divide across the top bit, where a signed compare of the int64
    # carrier would pick the other value
    def both_sides(w):                  # 0 where w is absent
        u = w.astype(np.uint64)
        return np.where(u % np.uint64(2) == 0, u, np.uint64(0) - u)

    W64 = W.astype(np.uint64)
    W64.data = both_sides(W.data)
    A64 = gt.Matrix.from_scipy(W64, device="cuda")
    At64 = gt.transpose(A64)
    assert A64.values.dtype == torch.uint64
    a64, b64 = both_sides(a), both_sides(b)
    both = ha & hb
    top = np.uint64(1 << 63)
    with np.errstate(over="ignore"):
        plus64 = a64 + b64
    min64 = np.where(both, np.minimum(a64, b64), np.where(ha, a64, b64))
    assert (plus64[both] < a64[both]).any(), "no wrap in the reference"
    assert ((a64[both] >= top) != (b64[both] >= top)).any(), \
        "no pair across 2^63 in the reference"
    for name, fn, keys, vals in (
            ("ewise_add_plus_u64",
             lambda: gt.ewise_add(A64, At64, ops.PLUS), u, plus64),
            ("ewise_add_min_u64",
             lambda: gt.ewise_add(A64, At64, ops.MIN), u, min64),
            ("ewise_mult_lt_u64",
             lambda: gt.ewise_mult(A64, At64, ops.LT), u[both],
             a64[both] < b64[both]),
            ("ewise_mult_div_u64",
             lambda: gt.ewise_mult(A64, At64, ops.DIV), u[both],
             a64[both] // b64[both])):
        C, walls[name + "_cold"], walls[name + "_warm"] = two_walls(fn)
        assert_entries(C, keys, vals, name)
        del C
    del A64, At64, W64, a64, b64, plus64, min64
    part("ewise_u64")
    # the dense path: a BITMAP and a SPARSE vector of 2^24
    m = 1 << 24
    xv = rng.integers(1, 100, m).astype(np.float32)
    xp = rng.random(m) < 0.5
    yi = np.flatnonzero(rng.random(m) < 0.1)
    yv = rng.integers(1, 100, yi.size).astype(np.float32)
    xd = gt.Vector.from_dense_masked(torch.from_numpy(xv).cuda(),
                                     torch.from_numpy(xp).cuda())
    yd = gt.Vector.from_coo(yi, yv, m, device="cuda")
    C, walls["ewise_add_dense_cold"], walls["ewise_add_dense_warm"] = \
        two_walls(lambda: gt.ewise_add(xd, yd, ops.PLUS))
    want = np.where(xp, xv, 0)
    want[yi] += yv
    wp = xp.copy()
    wp[yi] = True
    assert C.fmt == "bitmap"
    cv, cp = (t.cpu().numpy() for t in C.to_dense_1d())
    assert np.array_equal(cp, wp) and np.array_equal(cv[cp], want[wp]), \
        "dense path"
    del C, xd, yd
    part("dense")
    # pending events on a copy of A, then wait()
    pick = rng.integers(0, W.nnz, 1 << 20)
    stored = np.stack([ka[pick] // n, ka[pick] % n], 1)
    events = GT.pending_events(rng, (n, n), 100_000, 20_000, stored)

    def queue_and_wait():
        B = A.dup()
        t0 = time.perf_counter()
        for op, i, j, v in events:
            if op == "set":
                B.set_element(i, j, v)
            else:
                B.remove_element(i, j)
        q = time.perf_counter() - t0
        _, w = timed(B.wait)
        return B, q, w

    B, q_cold, walls["wait_cold"] = queue_and_wait()
    r, c, v = GT.apply_events(ka // n, ka % n, W.data, events, (n, n))
    assert_entries(B, r * n + c, v, "pending")
    assert B.values.device.type == "cuda"
    del B
    _, q_warm, walls["wait_warm"] = queue_and_wait()
    walls["queue_120000_events_cold"], walls["queue_120000_events_warm"] \
        = q_cold, q_warm
    part("pending")
    # bfs_parents from the vertex of highest out-degree
    src = int(np.argmax(np.diff(S.indptr)))
    P, walls["bfs_parents_cold"], walls["bfs_parents_warm"] = two_walls(
        lambda: gt.bfs_parents(A, src))
    pv, pp = (t.cpu().numpy() for t in P.to_dense_1d())
    lev = csg.shortest_path(S, unweighted=True, indices=src)
    assert np.array_equal(pp, np.isfinite(lev)), "bfs_parents reached set"
    kids = np.flatnonzero(pp)
    kids = kids[kids != src]
    assert pv[src] == src and (np.asarray(S[pv[kids], kids]).ravel()
                               != 0).all(), "parent edges"
    assert (lev[pv[kids]] == lev[kids] - 1).all(), "parent levels"
    del P
    part("bfs_parents")
    # connected components (A as undirected): scipy's weak components,
    # labelled by their least vertex
    L, walls["connected_components_cold"], \
        walls["connected_components_warm"] = two_walls(
            lambda: gt.connected_components(A))
    nc, lab = csg.connected_components(S, directed=True, connection="weak")
    least = np.full(nc, n)
    np.minimum.at(least, lab, np.arange(n))
    assert np.array_equal(L.cpu().numpy(), least[lab]), "components"
    part("components")
    # sssp_grb against Dijkstra (integer weights: exact)
    D, walls["sssp_grb_cold"], walls["sssp_grb_warm"] = two_walls(
        lambda: gt.sssp_grb(A, src))
    dv, dp = (t.cpu().numpy() for t in D.to_dense_1d())
    ref = csg.dijkstra(W, indices=src)
    assert np.array_equal(dp, np.isfinite(ref)) and \
        np.array_equal(dv[dp], ref[dp]), "sssp_grb"
    launches = kernel_launches()
    part("sssp_grb")
    # one warm ewise_add under the profiler: the device idle share
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall_p = timed(lambda: gt.ewise_add(A, At, ops.PLUS))
    busy = _busy_s([e for e in prof.events() if _on_device(e)])
    assert 0 < busy <= wall_p, (busy, wall_p)
    kern = sorted((e for e in prof.key_averages() if _on_device(e)
                   and _dev_us(e) > 0), key=lambda e: -_dev_us(e))
    top_k = ", ".join(f"{e.key[:40]} {_dev_us(e) / 1e3:.2f} ms x{e.count}"
                      for e in kern[:5])
    part("trace")
    print(f"[14 ewise/pending/algorithms] {card} | graph (b) RMAT-20 n={n} "
          f"nnz={W.nnz}, |A + A'|={u.size}, |A .* A'|={int(both.sum())}; "
          f"every step exact vs scipy/numpy (fp32 integer weights 1..255, "
          f"UINT64 w or 2^64 - w: PLUS wraps, MIN/LT/DIV across 2^63; "
          f"dense path 2^24; "
          f"100,000 sets + 20,000 removes; bfs_parents from {src}: "
          f"{int(pp.sum())} reached, depth {int(lev[pp].max())}; "
          f"{nc} components; sssp_grb = Dijkstra) | walls s: "
          + " ".join(f"{k}={v:.3f}" for k, v in walls.items())
          + f" | warm ewise_add traced: wall {wall_p:.4f} s, device busy "
          f"{busy:.4f} s (idle {1 - busy / wall_p:.1%}); top kernels {top_k}"
          f" | K1-K9 and KP launches during the phase: {launches} | phase "
          f"{time.perf_counter() - t_phase:.1f} s, by part (checks and host "
          f"references included): " + " ".join(
              f"{k}={v:.1f}" for k, v in parts.items()), flush=True)


# ---------------------------------------------------------------------------
# 15. the rest of the op layer and the operator sugar
# ---------------------------------------------------------------------------

def canon(M):
    """A scipy matrix as canonical CSR: sorted, summed, no zeros."""
    M = M.tocsr()
    M.sum_duplicates()
    M.eliminate_zeros()
    M.sort_indices()
    return M


def selector(idx, n):
    """The n x len(idx) 0/1 matrix P with P[idx[k], k] = 1 (P R P' places
    a region R at rows / columns idx)."""
    import scipy.sparse as sps
    return sps.csr_matrix((np.ones(idx.size, np.float32),
                           (idx, np.arange(idx.size))),
                          shape=(n, idx.size))


def assert_sci(M, want, what):
    """A port matrix equals a scipy matrix exactly (entries, values,
    value type); ``want`` is made canonical here."""
    want = canon(want)
    got_k, got_v = host_entries(M)
    assert M.shape == want.shape, f"{what}: shape {M.shape} {want.shape}"
    assert np.array_equal(got_k, csr_host_keys(want)), f"{what}: pattern"
    assert np.array_equal(got_v, want.data.astype(got_v.dtype)), \
        f"{what}: values"


def burbled(fn, word):
    """fn() with burble on; asserts a burble line holds ``word``."""
    import graphblas_tpu_torch as gt
    msgs = []
    gt.set_option("printf", msgs.append)
    gt.set_option("burble", True)
    try:
        out = fn()
    finally:
        gt.set_option("burble", False)
    assert any(word in m for m in msgs), (word, msgs)
    return out


def traced_share(fn):
    """One call of fn under torch.profiler: (wall s, device busy s, top
    device operations)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(fn)
    busy = _busy_s([e for e in prof.events() if _on_device(e)])
    assert 0 < busy <= wall, (busy, wall)
    kern = sorted((e for e in prof.key_averages() if _on_device(e)
                   and _dev_us(e) > 0), key=lambda e: -_dev_us(e))
    top = ", ".join(f"{e.key[:40]} {_dev_us(e) / 1e3:.2f} ms x{e.count}"
                    for e in kern[:4])
    return wall, busy, top


def gauss_step(S, rng, step, info):
    """Gauss integers {re, im} (a struct type of two int64 fields, as the
    reference's gauss_demo.c) on graph (b)'s raw RMAT edges, duplicates
    kept: a build whose dup is a user op, eWise add of G and G', reduce to
    a vector and to a scalar, each exact against scipy / numpy sums of
    the two fields (offset by 100 so that no sum is an explicit zero)."""
    import scipy.sparse as sps
    import torch

    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch.testing import rmat_edges
    n = S.shape[0]
    r, c, _ = rmat_edges(n.bit_length() - 1, 16, np.random.default_rng(7))
    re = rng.integers(-3, 4, r.size)
    im = rng.integers(-3, 4, r.size)
    gauss = gt.types.struct_type("Gauss", np.int64, (2,))
    add = gt.binary_op(lambda x, y: x + y, "gauss_add", commutative=True)
    mon = gt.make_monoid(add, identity=np.array([0, 0]))
    vals = torch.from_numpy(np.stack([re, im], 1)).cuda()
    rt, ct = torch.from_numpy(r).cuda(), torch.from_numpy(c).cuda()
    G = step("struct_build", lambda: gt.Matrix.from_coo(
        rt, ct, vals, (n, n), dtype=gauss, dup=add))
    info["struct_raw_edges"] = r.size
    info["struct_nnz"] = G.nvals

    # entry counts and the fields' sums, each member offset by 100
    P, RE, IM = (sps.csr_matrix((v, (r, c)), shape=(n, n))
                 for v in (np.ones(r.size, np.int64), re + 100, im + 100))
    for X in (P, RE, IM):
        X.sort_indices()

    def assert_gauss(M, P, RE, IM, what):
        keys, v = host_entries(M)
        assert np.array_equal(keys, csr_host_keys(P)), f"{what}: pattern"
        assert np.array_equal(v[:, 0], RE.data - 100 * P.data) and \
            np.array_equal(v[:, 1], IM.data - 100 * P.data), f"{what}: values"

    assert_gauss(G, P, RE, IM, "struct build")
    U = step("struct_ewise_add", lambda: gt.ewise_add(G, G.T, add))
    P2, RE2, IM2 = (canon(X + X.T) for X in (P, RE, IM))
    assert_gauss(U, P2, RE2, IM2, "struct ewise_add G + G'")
    info["struct_ewise_nnz"] = U.nvals
    del U, P2, RE2, IM2
    w = step("struct_reduce_rows", lambda: gt.reduce(G, mon))
    wv, wp = (t.cpu().numpy() for t in w.to_dense_pair())
    has = np.diff(P.indptr) > 0
    assert np.array_equal(wp[:, 0], has) and \
        np.array_equal(wv[has, 0, 0], np.bincount(r, re, n)[has]) and \
        np.array_equal(wv[has, 0, 1], np.bincount(r, im, n)[has]), \
        "struct reduce rows"
    s = step("struct_reduce_scalar", lambda: gt.reduce_scalar(G, mon))
    assert s.tolist() == [int(re.sum()), int(im.sum())], "struct reduce"


def op_layer_path(S, card):
    """Phase 15 at graph (b), integer weights 1..255 from seed 15: every
    step through gt.*, each held exactly against scipy/numpy on the host.
    extract A(I,I) for a random 9/16 of the vertices (the sentinel-sort
    branch: a random half keeps a quarter of the entries, on the branch's
    threshold), for a random 1/16 (the compact branch), A(I,J) for 2^16
    indices drawn with repeats (the sparse repeat path) and a masked,
    accumulated extract into an existing C; subassign C(I,J)<M> +=
    A(I2,J2), assign with a global mask (replace off), C(I,J) = scalar
    and C<M> = 0 with M = A' holding explicit false values (the
    sparse-mask fast path, 16 M mask entries); the sugar A[I, J], A[M],
    A[M] = x, A + A.T, 2 * A and A @ v (K2); kron of RMAT-14 with a
    64-vertex seed graph (2^20 vertices, ~16.7 M entries) against
    scipy.sparse.kron; split into 2x2 and 3x3 uneven tiles and concat
    back (bitwise A); diag(d, k) for k in {0, 1, -1} with d the
    out-degree and vector_diag of A + diag(d); resize to (n + 1000,
    n - 1000), reshape to (n/2, 2n) by column and by row; sort by LT and
    GT, an INT8 copy holding -128 and a UINT64 copy across 2^63,
    descending; gauss-integer struct values (two int64 fields) built from
    graph (b)'s 16.8 M raw RMAT edges with a user dup, eWise add of G and
    G', reduce to a vector and a scalar; serialize / deserialize with the
    codecs none, zlib and gbz (bitwise round trip, blob bytes, MB/s, one
    call each); from_mtx of an RMAT-16 file that scipy.io.mmwrite writes
    (RMAT-16, not 20: mmwrite of 16 M entries takes minutes).  Each
    step's wall cold and warm, one warm extract and one warm subassign
    traced, K1-K9 and KP launches during the phase."""
    import os
    import tempfile

    import scipy.io as sio
    import scipy.sparse as sps
    import torch

    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch.utils import native as NAT
    ops = gt.operators
    t_phase = time.perf_counter()
    rng = np.random.default_rng(15)
    n = S.shape[0]
    W = S.copy()
    W.data = rng.integers(1, 256, W.nnz).astype(np.float32)
    Wt = W.T.tocsr()
    A = gt.Matrix.from_scipy(W, device="cuda")
    walls, parts, info = {}, {}, {}
    t_part = [t_phase]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def step(name, fn):
        out, walls[name + "_cold"], walls[name + "_warm"] = two_walls(fn)
        return out

    def sub(k):
        return np.sort(rng.choice(n, k, replace=False))

    part("setup")
    reset_kernel_launches()
    # extract: the sentinel branch, the compact branch, repeats, masked
    I_big, I_small = sub(9 * n // 16), sub(n // 16)
    C = step("extract_9of16", lambda: burbled(
        lambda: gt.extract(A, I_big, I_big), "sparse renumber"))
    info["extract_9of16_nnz"] = C.nvals
    assert_sci(C, W[I_big][:, I_big], "extract 9/16")
    del C
    C = step("extract_1of16", lambda: gt.extract(A, I_small, I_small))
    assert_sci(C, W[I_small][:, I_small], "extract 1/16")
    R_small = C
    Ir = rng.integers(0, n, 1 << 16)
    Jr = rng.integers(0, n, 1 << 16)
    C = step("extract_repeats", lambda: burbled(
        lambda: gt.extract(A, Ir, Jr), "sparse repeat path"))
    assert_sci(C, W[Ir][:, Jr], "extract with repeats")
    info["extract_repeats_nnz"] = C.nvals
    del C
    I2 = sub(n // 16)
    M_sm = gt.Matrix.from_scipy(W[I2][:, I2] > 128, device="cuda")
    Mb = canon(W[I2][:, I2] > 128).astype(np.float32)
    C = step("extract_masked_accum", lambda: gt.extract(
        A, I2, I2, C=R_small.dup(), mask=M_sm, accum=ops.PLUS))
    Rs, T2 = W[I_small][:, I_small], W[I2][:, I2]
    Z = Rs + T2
    assert_sci(C, Rs - Rs.multiply(Mb) + Z.multiply(Mb),
               "masked accumulated extract")
    del C, R_small, M_sm
    part("extract")
    # subassign C(I,J)<M> += A(I2,J2) over a 2^16 x 2^16 region
    I, J = sub(1 << 16), sub(1 << 16)
    I3, J3 = sub(1 << 16), sub(1 << 16)
    A2 = gt.extract(A, I3, J3)
    A2s = W[I3][:, J3]
    Mv = W[I][:, J3].copy()
    Mv.data = Mv.data > 100          # explicit false where the weight <= 100
    M = gt.Matrix.from_scipy(Mv, device="cuda")
    Mtrue = canon(Mv).astype(np.float32)
    PI, PJ = selector(I, n), selector(J, n)
    Rg = W[I][:, J]
    C = step("subassign_mask_accum", lambda: gt.subassign(
        A.dup(), A2, I, J, mask=M, accum=ops.PLUS))
    Znew = Rg + A2s.multiply(Mtrue)
    assert_sci(C, W - PI @ Rg @ PJ.T + PI @ Znew @ PJ.T,
               "subassign C(I,J)<M> += A(I2,J2)")
    del C
    # assign with a global mask (n x n: A' with explicit false values)
    Mg_s = Wt.copy()
    Mg_s.data = Mg_s.data > 128      # explicit false where <= 128
    Mg = gt.Matrix.from_scipy(Mg_s, device="cuda")
    Mgb = canon(Mg_s).astype(np.float32)
    C = step("assign_global_mask", lambda: gt.assign(A.dup(), A2, I, J,
                                                     mask=Mg))
    A2g = PI @ A2s @ PJ.T
    Wreg = PI @ Rg @ PJ.T
    assert_sci(C, W - Wreg.multiply(Mgb) + A2g.multiply(Mgb),
               "assign C<M>(I,J) = A(I2,J2)")
    del C
    # C(I,J) = scalar over a 1024 x 1024 region
    Is, Js = sub(1024), sub(1024)
    C = step("subassign_scalar", lambda: gt.subassign(A.dup(), 7.0, Is, Js))
    PIs, PJs = selector(Is, n), selector(Js, n)
    full = sps.csr_matrix(np.full((1024, 1024), 7.0, np.float32))
    assert_sci(C, W - PIs @ W[Is][:, Js] @ PJs.T + PIs @ full @ PJs.T,
               "C(I,J) = 7")
    del C
    # C<M> = 0, M = A' by its values (explicit false), the fast path
    Mf_s = Wt.copy()
    Mf_s.data = Wt.data.astype(np.int64) % 2 == 0   # false where odd
    Mf = gt.Matrix.from_scipy(Mf_s, device="cuda")
    info["mask_entries"] = Mf.nvals
    Mfs = canon(Mf_s).astype(np.float32)
    C = step("assign_scalar_mask", lambda: burbled(
        lambda: gt.assign(A.dup(), 0.0, mask=Mf), "fast path"))
    E = canon(W + 1000 * Mfs)
    assert_entries(C, csr_host_keys(E),
                   np.where(E.data >= 1000, 0, E.data).astype(np.float32),
                   "C<M> = 0")
    del C, Mg
    part("assign")
    # the sugar
    C = step("sugar_A[I,J]", lambda: A[I_small, I_small])
    assert_sci(C, W[I_small][:, I_small], "A[I, J]")
    C = step("sugar_A[M]", lambda: A[Mf])
    assert_sci(C, W.multiply(Mfs), "A[M]")

    def set_mask():
        B = A.dup()
        B[Mf] = 0.0
        return B

    C = step("sugar_A[M]=0", set_mask)
    assert_entries(C, csr_host_keys(E),
                   np.where(E.data >= 1000, 0, E.data).astype(np.float32),
                   "A[M] = 0")
    del E
    C = step("sugar_A+A.T", lambda: A + A.T)
    u, a, b = union_ref(W, Wt)
    assert_entries(C, u, (a + b).astype(np.float32), "A + A.T")
    del u, a, b
    C = step("sugar_2*A", lambda: 2 * A)
    assert C.dtype == gt.types.FP64
    assert_sci(C, 2 * W.astype(np.float64), "2 * A")
    x = gt.Vector.from_dense(torch.ones(n, dtype=torch.float32,
                                        device="cuda"))
    rowsum = np.asarray(W.astype(np.float64).sum(axis=1)).ravel()
    assert rowsum.max() < 2 ** 24      # every partial sum exact in fp32
    y = step("sugar_A@v", lambda: A @ x)
    yv, yp = (t.cpu().numpy() for t in y.to_dense_1d())
    has = np.diff(W.indptr) > 0            # empty rows: no entry in y
    assert np.array_equal(yp, has) and np.array_equal(
        yv[has], rowsum[has].astype(np.float32)), "A @ v"
    del C, y, x, Mf, Mfs
    part("sugar")
    # kron: RMAT-14 (weights) x a 64-vertex seed graph of 64 edges
    G = rmat_graph(14)
    G.data = rng.integers(1, 256, G.nnz).astype(np.float32)
    sd = sps.csr_matrix((rng.integers(1, 5, 64).astype(np.float32),
                         (rng.integers(0, 64, 64), rng.integers(0, 64, 64))),
                        shape=(64, 64))
    sd.sum_duplicates()
    Gt = gt.Matrix.from_scipy(G, device="cuda")
    Sd = gt.Matrix.from_scipy(sd, device="cuda")
    K = step("kron", lambda: gt.kronecker(Gt, Sd, ops.TIMES))
    info["kron_nnz"] = K.nvals
    assert_sci(K, sps.kron(G, sd), "kron")
    del K, Gt, Sd, G
    part("kron")
    # split into 2x2 and 3x3 uneven tiles, concat back: bitwise A
    for grid, rs in (("2x2", [n // 2, n - n // 2]),
                     ("3x3", [n // 5, n // 2, n - n // 5 - n // 2])):
        tiles = step(f"split_{grid}", lambda: gt.split(A, rs, rs))
        C = step(f"concat_{grid}", lambda: gt.concat(tiles))
        assert all(torch.equal(getattr(C, f), getattr(A, f))
                   for f in ("indptr", "indices", "values")), grid
        del tiles, C
    part("concat")
    # diag of the out-degree, vector_diag of A + diag(d)
    deg = np.diff(W.indptr).astype(np.float32)
    d = gt.Vector.from_dense(torch.from_numpy(deg).cuda())
    ar = np.arange(n, dtype=np.int64)
    for k in (0, 1, -1):
        D = step(f"diag_{k}", lambda: gt.diag(d, k))
        dim = n + abs(k)          # every entry of d is stored, zeros too
        assert_entries(D, (ar + max(-k, 0)) * dim + ar + max(k, 0), deg,
                       f"diag k={k}")
    D0 = gt.diag(d, 0)
    v = step("vector_diag", lambda: gt.vector_diag(
        gt.ewise_add(A, D0, ops.PLUS), 0))
    vv, vp = (t.cpu().numpy() for t in v.to_dense_1d())
    assert vp.all() and np.array_equal(vv, W.diagonal() + deg), \
        "vector_diag"
    del D, D0, d, v
    part("diag")
    # resize; reshape to (n/2, 2n) by column and by row
    def resized():
        B = A.dup()
        B.resize(n + 1000, n - 1000)
        return B

    C = step("resize", resized)
    Wr = W[:, :n - 1000].tocsr()
    assert_sci(C, sps.vstack([Wr, sps.csr_matrix((1000, n - 1000),
                                                 dtype=np.float32)]),
               "resize")
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(W.indptr))
    cols = W.indices.astype(np.int64)
    lin = cols * n + rows
    ref = sps.csr_matrix((W.data, (lin % (n // 2), lin // (n // 2))),
                         shape=(n // 2, 2 * n))
    C = step("reshape_by_col", lambda: A.reshape(n // 2, 2 * n))
    assert_sci(C, ref, "reshape by column")
    C = step("reshape_by_row", lambda: A.reshape(n // 2, 2 * n,
                                                 by_col=False))
    lin = rows * n + cols
    assert_sci(C, sps.csr_matrix((W.data, (lin // (2 * n), lin % (2 * n))),
                                 shape=(n // 2, 2 * n)), "reshape by row")
    del C, ref, lin
    part("resize")
    # sort: LT and GT; INT8 holding -128 and UINT64 across 2^63, GT
    w = W.data.astype(np.int64)
    starts = np.repeat(W.indptr[:-1].astype(np.int64), np.diff(W.indptr))

    def check_sort(M, rank, top, what, op):
        CP = step(what, lambda: gt.sort(M, op))
        order = np.argsort(rows * (top + 1) + rank, kind="stable")
        cv, pv = (host_entries(X) for X in CP)
        ranks = np.arange(w.size) - starts
        assert np.array_equal(cv[0], rows * n + ranks), f"{what}: C pattern"
        assert np.array_equal(pv[0], cv[0]), f"{what}: P pattern"
        assert np.array_equal(pv[1], cols[order]), f"{what}: P"
        return cv[1], order

    got, order = check_sort(A, w, 255, "sort_LT", ops.LT)
    assert np.array_equal(got, W.data[order]), "sort LT values"
    got, order = check_sort(A, 255 - w, 255, "sort_GT", ops.GT)
    assert np.array_equal(got, W.data[order]), "sort GT values"
    W8 = W.copy()
    W8.data = (w - 129).astype(np.int8)             # -128 .. 126
    assert (W8.data == -128).any()
    A8 = gt.Matrix.from_scipy(W8, device="cuda")
    got, order = check_sort(A8, 126 - (w - 129), 255, "sort_GT_int8",
                            ops.GT)
    assert np.array_equal(got, W8.data[order]) and got.dtype == np.int8, \
        "sort INT8 GT values"
    del A8, W8
    hi = w % 2 == 0                                 # above 2^63 where even
    u64 = np.where(hi, np.uint64(1 << 63), np.uint64(1 << 62)) + \
        w.astype(np.uint64)
    W64 = W.astype(np.uint64)
    W64.data = u64
    A64 = gt.Matrix.from_scipy(W64, device="cuda")
    assert A64.values.dtype == torch.uint64
    got, order = check_sort(A64, 511 - (hi * 256 + w), 511,
                            "sort_GT_uint64", ops.GT)
    assert np.array_equal(got, u64[order]), "sort UINT64 GT values"
    del A64, W64, u64, got, order, starts
    part("sort")
    # gauss-integer struct values: build with a user dup, eWise, reduce
    gauss_step(S, rng, step, info)
    part("struct")
    # serialize / deserialize
    mbytes = sum(t.numel() * t.element_size()
                 for t in (A.indptr, A.indices, A.values)) / 1e6
    for codec in ("none", "zlib", "gbz"):      # one call each: host-bound
        blob, walls[f"serialize_{codec}"] = timed(
            lambda: gt.serialize(A, codec))
        B, walls[f"deserialize_{codec}"] = timed(
            lambda: gt.deserialize(blob, device="cuda"))
        assert all(torch.equal(getattr(B, f), getattr(A, f))
                   for f in ("indptr", "indices", "values")), codec
        info[f"{codec}_MB"] = len(blob) / 1e6
        info[f"{codec}_write_MB_s"] = mbytes / walls[f"serialize_{codec}"]
        info[f"{codec}_read_MB_s"] = mbytes / walls[f"deserialize_{codec}"]
        del blob, B
    part("serialize")
    # from_mtx of an RMAT-16 file written by scipy
    W16 = rmat_graph(16)
    W16.data = rng.integers(1, 256, W16.nnz).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rmat16.mtx")
        sio.mmwrite(path, W16)
        part("mmwrite")
        M16 = step("from_mtx", lambda: gt.Matrix.from_mtx(path,
                                                          device="cuda"))
    info["mtx_reader"] = "native" if NAT.library() is not None else "scipy"
    assert_sci(M16, W16.astype(np.float64), "from_mtx")
    del M16
    launches = kernel_launches()
    assert launches["K2"] > 0, launches
    part("from_mtx")
    # one warm extract and one warm subassign under the profiler
    gt.extract(A, I_big, I_big)
    tr = {"extract_9of16": traced_share(lambda: gt.extract(A, I_big,
                                                           I_big))}
    tr["subassign"] = traced_share(lambda: gt.subassign(
        A.dup(), A2, I, J, mask=M, accum=ops.PLUS))
    part("trace")
    print(f"[15 op layer] {card} | graph (b) RMAT-20 n={n} nnz={W.nnz}, "
          f"weights 1..255; every step exact vs scipy/numpy | "
          + " ".join(f"{k}={v}" for k, v in info.items())
          + " | walls s: " + " ".join(f"{k}={v:.4f}" for k, v in
                                     walls.items())
          + " | traced warm: " + "; ".join(
              f"{k} wall {w_:.4f} s, device busy {b_:.4f} s (idle "
              f"{1 - b_ / w_:.1%}), top {t_}" for k, (w_, b_, t_) in
              tr.items())
          + f" | K1-K9 and KP launches during the phase: {launches} | phase "
          f"{time.perf_counter() - t_phase:.1f} s, by part (checks and "
          f"host references included): " + " ".join(
              f"{k}={v:.1f}" for k, v in parts.items()), flush=True)


# ---------------------------------------------------------------------------
# 16. the distributed tier: a world-size-1 NCCL group at full size
# ---------------------------------------------------------------------------

def traced_nccl(fn, calls=1):
    """``calls`` calls of fn back to back under torch.profiler, per call:
    (wall s, device busy s, NCCL kernels' device ms and launches, top
    device operations).  Busy is None (not measured) when the profiler
    returned no device event, as it once did for a single dist_mxv (0.2
    ms of kernels) late in a full run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: [fn() for _ in range(calls)])
    dev = [e for e in prof.events() if _on_device(e)]
    busy = _busy_s(dev)
    assert busy <= wall, (busy, wall)
    nccl = [e for e in dev if "nccl" in e.name.lower()]
    nccl_ms = sum(e.time_range.end - e.time_range.start for e in nccl) / 1e3
    kern = sorted((e for e in prof.key_averages() if _on_device(e)
                   and _dev_us(e) > 0), key=lambda e: -_dev_us(e))
    top = ", ".join(f"{e.key[:40]} {_dev_us(e) / 1e3 / calls:.3f} ms "
                    f"x{e.count / calls:g}" for e in kern[:4])
    return (wall / calls, busy / calls if dev else None,
            (nccl_ms / calls, len(nccl) / calls), top)


def min_plus_ref(S, x):
    """y_i = min over row i of (x_k + a_ik) in fp32 on the host, +inf for
    an empty row."""
    y = np.full(S.shape[0], np.inf, np.float32)
    has = np.diff(S.indptr) > 0
    y[has] = np.minimum.reduceat(x[S.indices] + S.data,
                                 S.indptr[:-1][has])
    return y


def dist_path(S, card):
    """Phase 16: the distributed tier (graphblas_tpu_torch.parallel) on a
    world-size-1 NCCL group started in this process (launch.init with a
    file rendezvous, device_id cuda:0), torn down at the end.  At graph
    (b): from_matrix; dist_mxv plus-times fp32 before the shard has a
    plan (bitwise K2 on the whole CSR), min-plus (K3, builds the plan;
    exact against the host), fp64 (K4; 1e-12 * max|y| of scipy's fp64),
    with mask + accum and with a complemented mask (K1, 1e-5 * max|y|);
    dist_vxm plus-times against scipy S' x (1e-5 * max|y|);
    dist_reduce_scalar (the nnz, exact); dist_bfs_levels from the hub
    (exact against scipy); dist_pagerank 20 steps (1e-4 of fp64 numpy);
    the 1x1 dist_mxv_2d (bitwise K2); save_sharded / load_sharded (the
    arrays equal).  At graph (a): dist_mxm A*A (SELL, K5; cnnz
    268,406,919, 4096 sampled rows exact, fp64 checksum).  Then
    dryrun_multichip(1): one spawned NCCL rank.  Each step's wall cold
    and warm, one warm dist_pagerank and one warm dist_mxv traced (idle
    share, NCCL kernels' device time), the K1-K9 and KP launches during the
    phase (K2, K3, K4 and K5 each > 0)."""
    import os
    import shutil
    import tempfile

    import scipy.sparse.csgraph as csg
    import torch

    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch import parallel as par
    from graphblas_tpu_torch.core import semiring as SR
    from graphblas_tpu_torch.entry import dryrun_multichip
    from graphblas_tpu_torch.kernels import spmv_onehot as OH
    from graphblas_tpu_torch.parallel import launch
    t_phase = time.perf_counter()
    rng = np.random.default_rng(16)
    n = S.shape[0]
    walls, parts, info = {}, {}, {}
    t_part = [t_phase]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def step(name, fn):
        out, walls[name + "_cold"], walls[name + "_warm"] = two_walls(fn)
        return out

    tmp = tempfile.mkdtemp(prefix="gbt_phase16_")
    dev = launch.init(0, 1, "cuda:0", "file://" + os.path.join(tmp, "rdzv"))
    info["backend"] = torch.distributed.get_backend()
    assert info["backend"] == "nccl" and dev == torch.device("cuda", 0)
    mesh = par.make_mesh(1)
    A = gt.Matrix.from_scipy(S, device="cuda")
    x = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    xa = np.abs(x)
    xt = torch.from_numpy(x).cuda()
    S64 = S.astype(np.float64)
    part("setup")
    reset_kernel_launches()
    D = step("from_matrix", lambda: par.DistMatrix.from_matrix(A, mesh))
    y = step("mxv_f32", lambda: par.dist_mxv(D, xt))
    part("mxv_f32")
    n0 = OH.launches                       # the comparison's K2 is not
    k2 = OH.spmv(A.indptr, A.indices, A.values, xt, n)       # the path's
    OH.launches = n0
    assert torch.equal(y, k2), "dist_mxv != K2 on the whole CSR"
    ymin = step("mxv_min_plus", lambda: par.dist_mxv(D, xa, SR.MIN_PLUS))
    assert np.array_equal(ymin.cpu().numpy(), min_plus_ref(S, xa)), \
        "dist_mxv min-plus"
    x64 = x.astype(np.float64)
    y64 = step("mxv_f64", lambda: par.dist_mxv(D, x64))
    ref = S64 @ x64
    err64 = float(np.abs(y64.cpu().numpy() - ref).max())
    assert y64.dtype == torch.float64 and \
        err64 <= FP64_TOL * np.abs(ref).max(), err64
    info["mxv_f64_err"] = err64
    c = rng.standard_normal(n).astype(np.float32)
    m = rng.random(n) < 0.5
    ym = step("mxv_mask_accum", lambda: par.dist_mxv(
        D, xt, mask=m, accum=gt.operators.PLUS, c=c))
    want = np.where(m, c + ref, c)
    info["mask_accum_err"] = float(np.abs(ym.cpu().numpy() - want).max())
    assert info["mask_accum_err"] <= FP32_TOL * np.abs(want).max()
    yc = step("mxv_complement", lambda: par.dist_mxv(
        D, xt, mask=m, c=c, mask_complement=True))
    want = np.where(~m, ref, c)
    info["complement_err"] = float(np.abs(yc.cpu().numpy() - want).max())
    assert info["complement_err"] <= FP32_TOL * np.abs(want).max()
    part("mxv")
    w = step("vxm_f32", lambda: par.dist_vxm(D, xt))
    wref = S64.T @ x64
    info["vxm_err"] = float(np.abs(w.cpu().numpy() - wref).max())
    assert info["vxm_err"] <= FP32_TOL * np.abs(wref).max()
    tot = step("reduce_scalar", lambda: par.dist_reduce_scalar(D))
    assert tot.dim() == 0 and float(tot) == S.nnz, float(tot)
    part("vxm_reduce")
    src = int(np.argmax(np.diff(S.indptr)))
    lv = step("bfs_levels", lambda: par.dist_bfs_levels(D, src))
    lref = csg.dijkstra(S, indices=src, unweighted=True)
    reach = np.isfinite(lref)
    assert np.array_equal(lv.cpu().numpy(), np.where(
        reach, lref, -1).astype(np.int32)), "dist_bfs_levels"
    info["bfs_reached"], info["bfs_depth"] = int(reach.sum()), \
        int(lref[reach].max())
    part("bfs")
    r = step("pagerank_20", lambda: par.dist_pagerank(D, tol=0.0,
                                                      max_iter=20))
    info["pagerank_relerr"] = relerr(r.cpu().numpy(), pagerank_ref(S))
    assert info["pagerank_relerr"] <= RELERR_GUARD, info
    part("pagerank")
    mesh2 = par.make_mesh_2d(1, 1)
    D2 = step("from_matrix_2d",
              lambda: par.DistMatrix2D.from_matrix(A, mesh2))
    y2 = step("mxv_2d", lambda: par.dist_mxv_2d(D2, xt))
    assert torch.equal(y2, k2), "dist_mxv_2d != K2 on the whole CSR"
    del D2
    part("mxv_2d")
    ck = os.path.join(tmp, "ckpt")
    walls["save_sharded"] = timed(lambda: par.save_sharded(D, ck))[1]
    D3, walls["load_sharded"] = timed(lambda: par.load_sharded(ck, mesh))
    assert D3.nnz == D.nnz and D3.shape == D.shape and all(
        torch.equal(getattr(D3, f), getattr(D, f))
        for f in ("indptr", "indices", "values")), "checkpoint"
    info["ckpt_MB"] = sum(os.path.getsize(os.path.join(ck, f))
                          for f in os.listdir(ck)) / 1e6
    del D3
    part("checkpoint")
    # warm dist_mxv (K1: the plan exists now; 10 calls, per call) and one
    # warm dist_pagerank traced
    tr = {"dist_mxv": traced_nccl(lambda: par.dist_mxv(D, xt), calls=10),
          "dist_pagerank_20": traced_nccl(lambda: par.dist_pagerank(
              D, tol=0.0, max_iter=20))}
    part("trace")
    del D, A, y, k2
    # graph (a): dist_mxm A*A on SELL
    Sa = bench_graph()
    Aa = gt.Matrix.from_scipy(Sa, device="cuda")
    Da = par.DistMatrix.from_matrix(Aa, mesh)
    part("graph_a")
    DC, walls["mxm_a_cold"] = timed(lambda: par.dist_mxm(Da, Da))
    C = gt.Matrix(Sa.shape, DC.values.dtype, gt.SPARSE, gt.ROW,
                  indptr=DC.indptr, indices=DC.indices[:DC.nnz],
                  values=DC.values[:DC.nnz])
    info["mxm_checksum"] = check_product(C, Sa, rng, UNIFORM_CNNZ,
                                         "dist_mxm A*A")
    del C, DC
    DC, walls["mxm_a_warm"] = timed(lambda: par.dist_mxm(Da, Da))
    assert DC.nnz == UNIFORM_CNNZ
    del DC, Da, Aa
    part("mxm_a")
    launches = kernel_launches()
    assert all(launches[k] > 0 for k in ("K2", "K3", "K4", "K5")), launches
    launch.shutdown()
    shutil.rmtree(tmp)
    _, walls["dryrun_multichip_1"] = timed(lambda: dryrun_multichip(1))
    part("dryrun")
    print(f"[16 dist] {card} | world size 1, NCCL, graph (b) RMAT-20 n={n} "
          f"nnz={S.nnz}, dist_mxm at graph (a) | dist_mxv fp32 bitwise K2, "
          f"min-plus exact, dist_mxv_2d bitwise K2, BFS exact, checkpoint "
          f"equal, cnnz {UNIFORM_CNNZ} sampled rows exact | "
          + " ".join(f"{k}={v}" for k, v in info.items())
          + " | walls s: " + " ".join(f"{k}={v:.4f}" for k, v in
                                     walls.items())
          + " | traced warm, per call: " + "; ".join(
              f"{k} wall {w_:.5f} s, " + (
                  f"device busy {b_:.5f} s (idle {1 - b_ / w_:.1%}), "
                  if b_ is not None else "device busy not measured (the "
                  "profiler returned no device event), ")
              + f"NCCL kernels {nc[0]:.4f} ms x{nc[1]:g}, top {t_}"
              for k, (w_, b_, nc, t_) in tr.items())
          + f" | K1-K9 and KP launches during the phase: {launches} | phase "
          f"{time.perf_counter() - t_phase:.1f} s, by part (checks and "
          f"host references included): " + " ".join(
              f"{k}={v:.1f}" for k, v in parts.items()), flush=True)



# ---------------------------------------------------------------------------
# 17. the last public surface: the demos, GxB_BF16, the user algebra
# ---------------------------------------------------------------------------

def bf16_round(x):
    """float64 values rounded once to bf16 (8 significant bits, ties to
    even), as float64: numpy only, independent of the port's cast."""
    m, e = np.frexp(np.asarray(x, np.float64))
    return np.ldexp(np.round(m * 256.0), e - 8)


def bf16_ulp(x):
    """The spacing of bf16 values at |x| (x normal)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def demo_checks(step, info):
    """Each demo's main(device="cuda") at its own sizes, held against
    numpy/scipy as the JAX demo checks it (the demos assert their own
    claims too)."""
    import scipy.sparse as sps
    from scipy.sparse.csgraph import shortest_path

    from graphblas_tpu_torch.examples import (bfs_demo, context_demo,
                                              gauss_demo, kron_demo,
                                              semiring_demo, serialize_demo)
    r = step("bfs_demo", lambda: bfs_demo.main(device="cuda"))
    S = bfs_demo.graph()
    d = shortest_path(S, unweighted=True, indices=0)
    want = np.where(np.isinf(d), -1, d).astype(np.int64)
    assert np.array_equal(r["levels"], want), "bfs_demo levels"
    assert np.array_equal(r["fused_levels"], want), "bfs_demo fused"
    par, got = r["parents"], want >= 0
    v = np.flatnonzero(got & (np.arange(S.shape[0]) != 0))
    assert par[0] == 0 and np.all(par[~got] == -1) and \
        np.all(want[par[v]] == want[v] - 1) and \
        np.all(np.asarray(S[par[v], v]).ravel() != 0), "bfs_demo parents"
    info["bfs_reached"], info["bfs_levels"] = r["reached"], r["max_level"]
    r = step("context_demo", lambda: context_demo.main(device="cuda"))
    assert np.abs(r["y"] - r["want"]).max() <= FP64_TOL * \
        np.abs(r["want"]).max(), "context_demo y"
    info["context_sum"] = r["results"][0]
    r = step("gauss_demo", lambda: gauss_demo.main(device="cuda"))
    rng = np.random.default_rng(0)
    va = np.stack([rng.integers(-3, 4, (4, 4)),
                   rng.integers(-3, 4, (4, 4))], axis=-1)
    ca = va[..., 0] + 1j * va[..., 1]
    s = (ca @ ca).sum()
    assert list(r["sum"]) == [s.real, s.imag], "gauss_demo sum"
    r = step("kron_demo", lambda: kron_demo.main(device="cuda"))
    seed = sps.csr_matrix((np.ones(5), kron_demo.SEED), shape=(3, 3))
    K = seed
    for _ in range(3):
        K = sps.kron(K, seed, format="csr")
    assert_sci(r["graph"], K, "kron_demo")
    deg = np.diff(canon(K).indptr)
    assert (r["max_out_degree"], r["empty_rows"]) == \
        (int(deg.max()), int((deg == 0).sum())), "kron_demo degrees"
    r = step("semiring_demo", lambda: semiring_demo.main(device="cuda"))
    assert np.array_equal(r["distances"], [0, 1, 2, 3]), "min-plus"
    assert np.abs(r["lse"] - np.log(1 / 3)).max() <= FP64_TOL, "lse"
    assert np.array_equal(r["clipped"], [[0, 0.5], [1, 0.1]]), "clip01"
    r = step("serialize_demo", lambda: serialize_demo.main(device="cuda"))
    info["serialize_demo_bytes"] = {k: v[0] for k, v in r["blobs"].items()}


def surface_path(S, card):
    """Phase 17: the last public surface on the card.  Each demo's
    main(device="cuda") at its own sizes, held against numpy/scipy; at
    graph (b) with integer weights 1..8 from seed 17: BF16 ewise_add PLUS
    of A and A' (pattern and values exact), mxv PLUS_TIMES with x = 1
    (each row the float64 row sum rounded once to bf16: the sums are
    exact in float32), reduce_scalar PLUS (within one bf16 ulp of the
    float64 total), apply AINV (exact) and a serialize / deserialize
    round trip (codec none; bitwise); semiring_demo's LSE_PLUS mxv over A in fp32
    through the generic segmented scan (1e-5 relative of numpy's float64
    logaddexp per row) and its clip01 apply (exact); context_demo's four
    threads, each an fp32 mxv under its own Context(device="cuda"), the
    four results bitwise equal to each other and to one K2 call (K2
    launched 4 times); pack / unpack of A (bitwise); kron_demo's seed
    taken to 10 factors (59,049 vertices, 9,765,625 entries) exact
    against a chain of scipy.sparse.kron; gauss_demo's semiring (a
    struct type, user add and mult) through mxm on a uniform graph of
    n = 2^16, degree 8, exact against scipy's complex128 product.  Each
    step's wall cold and warm, and the K1-K9 and KP launches of its cold
    call."""
    import scipy.sparse as sps
    import torch

    import graphblas_tpu_torch as gt
    from graphblas_tpu_torch.examples import (context_demo, gauss_demo,
                                              kron_demo, semiring_demo)
    from graphblas_tpu_torch.kernels import spmv_onehot as OH
    from graphblas_tpu_torch.ops import serialize as SER
    BF16 = gt.types.BF16
    t_phase = time.perf_counter()
    walls, launched, info = {}, {}, {}

    def step(name, fn):
        reset_kernel_launches()
        out, cold = timed(fn)
        launched[name] = {k: v for k, v in kernel_launches().items() if v}
        del out
        out, warm = timed(fn)
        walls[name] = (cold, warm)
        return out

    demo_checks(step, info)
    t_demos = time.perf_counter() - t_phase

    # BF16 at graph (b)
    rng = np.random.default_rng(17)
    n = S.shape[0]
    W = S.copy()
    W.data = rng.integers(1, 9, W.nnz).astype(np.float32)
    A = gt.Matrix.from_scipy(W, dtype=BF16, device="cuda")
    assert A.dtype is BF16 and A.values.dtype == torch.bfloat16
    U = step("bf16_ewise_add", lambda: gt.ewise_add(A, gt.transpose(A),
                                                    gt.operators.PLUS))
    Uw = canon(W.astype(np.float64) + W.T.astype(np.float64))
    info["bf16_ewise_nnz"] = U.nvals
    assert U.nvals == Uw.nnz == 31_400_481, (U.nvals, Uw.nnz)
    assert U.dtype is BF16
    assert_sci(U, Uw, "bf16 ewise_add A + A'")
    del U, Uw
    x = gt.Vector.from_dense(torch.ones(n, dtype=torch.bfloat16,
                                        device="cuda"))
    y = step("bf16_mxv", lambda: gt.mxv(A, x, gt.semiring.PLUS_TIMES))
    yv, yp = (gt.types.host(t).reshape(-1) for t in y.to_dense_pair())
    rows = np.asarray(W.sum(axis=1), np.float64).ravel()
    has = np.diff(W.indptr) > 0
    assert y.dtype is BF16 and np.array_equal(yp, has), "bf16 mxv pattern"
    assert np.array_equal(yv[has], bf16_round(rows[has])), "bf16 mxv"
    info["bf16_max_row_sum"] = float(rows.max())
    s = step("bf16_reduce_scalar", lambda: gt.reduce_scalar(
        A, gt.monoid.PLUS))
    total = float(W.data.astype(np.float64).sum())
    assert abs(float(s) - total) <= bf16_ulp(total), (float(s), total)
    info["bf16_total"], info["bf16_sum"] = total, float(s)
    N = step("bf16_apply_ainv", lambda: gt.apply(A, gt.operators.AINV))
    assert_sci(N, -W.astype(np.float64), "bf16 apply AINV")
    del N
    B = step("bf16_serialize", lambda: gt.deserialize(
        gt.serialize(A, compression="none"), device="cuda"))
    assert B.dtype is BF16 and torch.equal(B.indptr, A.indptr) and \
        torch.equal(B.indices, A.indices) and torch.equal(
            B.values.view(torch.int16), A.values.view(torch.int16)), \
        "bf16 serialize"
    del B
    # the user algebra of semiring_demo, fp32 at graph (b)
    A32 = gt.Matrix.from_scipy(W, device="cuda")
    z = gt.Vector.from_dense(torch.zeros(n, device="cuda"))
    y = step("lse_plus_mxv", lambda: gt.mxv(A32, z, semiring_demo.LSE_PLUS))
    yv, yp = (t.cpu().numpy().reshape(-1) for t in y.to_dense_pair())
    want = np.logaddexp.reduceat(W.data.astype(np.float64),
                                 W.indptr[:-1][has])
    assert np.array_equal(yp, has), "lse pattern"
    info["lse_max_rel_err"] = float(np.max(np.abs(yv[has] - want)
                                           / np.abs(want)))
    assert info["lse_max_rel_err"] <= FP32_TOL, info["lse_max_rel_err"]
    Wc = W.copy()
    Wc.data = (Wc.data - 4) / 4
    Ac = gt.Matrix.from_scipy(Wc, device="cuda")
    C = step("clip01_apply", lambda: gt.apply(Ac, semiring_demo.CLIP01))
    want = Wc.copy()
    want.data = np.clip(want.data, 0.0, 1.0)
    got_k, got_v = host_entries(C)
    assert np.array_equal(got_k, csr_host_keys(W)) and \
        np.array_equal(got_v, want.data), "clip01"
    del C, Ac
    # context_demo's threads: fp32 mxv under four Contexts (K2)
    ones = torch.ones(n, dtype=torch.float32)
    ys = step("context_threads", lambda: context_demo.run_threads(
        A32, ones, torch.device("cuda"), 4))
    assert launched["context_threads"].get("K2") == 4, launched
    ref = OH.spmv(A32.indptr, A32.indices, A32.values,
                  ones.to("cuda"), n)
    assert all(torch.equal(ys[t], ref) for t in range(4)), \
        "threads != one K2 call"
    yk = ref.cpu().numpy()
    assert np.array_equal(yk[has], rows[has].astype(np.float32)), \
        "K2 row sums"
    # pack / unpack of (b)
    def pack_unpack():
        meta, arrays = SER.unpack(A32.dup())
        return SER.pack(A32.shape, meta["dtype"], meta["format"],
                        meta["orient"], device="cuda",
                        **{k: v for k, v in arrays.items() if v is not None})
    P = step("pack_unpack", pack_unpack)
    assert all(torch.equal(getattr(P, k), getattr(A32, k))
               for k in ("indptr", "indices", "values")), "pack/unpack"
    del P, A, A32, x, y, z, ys, ref
    # kron_demo's seed to 10 factors
    r = step("kron_10", lambda: kron_demo.main(device="cuda", levels=9))
    seed = sps.csr_matrix((np.ones(5), kron_demo.SEED), shape=(3, 3))
    K = seed
    for _ in range(9):
        K = sps.kron(K, seed, format="csr")
    assert (r["nrows"], r["nvals"]) == (59_049, 9_765_625) == \
        (K.shape[0], K.nnz), (r["nrows"], r["nvals"])
    assert_sci(r["graph"], K, "kron 10 factors")
    info["kron_10"] = (r["nrows"], r["nvals"], r["max_out_degree"])
    del r, K
    # gauss_demo's semiring through mxm at n = 2^16, degree 8
    gauss, _, sr = gauss_demo.algebra()
    Su = uniform_graph(1 << 16, 8, 17)
    Su.sort_indices()
    re, im = (rng.integers(-3, 4, Su.nnz) for _ in range(2))
    rr = np.repeat(np.arange(Su.shape[0]), np.diff(Su.indptr))
    G = gt.Matrix.from_coo(torch.from_numpy(rr).cuda(),
                           torch.from_numpy(Su.indices.astype(np.int64))
                           .cuda(),
                           torch.from_numpy(np.stack([re, im], 1)).cuda(),
                           Su.shape, dtype=gauss)
    products = int(np.diff(Su.indptr)[Su.indices].sum())
    assert products >= 10 ** 6, products
    C = step("gauss_mxm", lambda: gt.mxm(G, G, sr))
    Sp = sps.csr_matrix((np.ones(Su.nnz, np.int64), Su.indices, Su.indptr),
                        shape=Su.shape)
    Pk = csr_host_keys(canon(Sp @ Sp))
    Sc = sps.csr_matrix((re + 1j * im, Su.indices, Su.indptr),
                        shape=Su.shape)
    Cc = (Sc @ Sc).tocsr()
    Cc.sort_indices()
    ck = csr_host_keys(Cc)
    at = np.searchsorted(ck, Pk)
    hit = (at < ck.size) & (ck[np.minimum(at, ck.size - 1)] == Pk)
    want = np.where(hit, Cc.data[np.minimum(at, ck.size - 1)], 0)
    got_k, got_v = host_entries(C)
    assert np.array_equal(got_k, Pk), "gauss mxm pattern"
    assert np.array_equal(got_v[:, 0], want.real) and \
        np.array_equal(got_v[:, 1], want.imag), "gauss mxm values"
    info["gauss_mxm"] = (Su.shape[0], Su.nnz, products, C.nvals)
    del C, G
    print(f"[17 surface] {card} | demos at their sizes and BF16, the user "
          f"algebra, threads, pack/unpack at graph (b) RMAT-20 n={n} "
          f"nnz={W.nnz} weights 1..8; kron 10 factors; gauss mxm; every "
          f"step exact vs numpy/scipy (LSE <= {FP32_TOL} rel, BF16 sum "
          f"<= 1 ulp) | " + " ".join(f"{k}={v}" for k, v in info.items())
          + " | walls s (cold, warm): " + " ".join(
              f"{k}=({c:.4f}, {w:.4f})" for k, (c, w) in walls.items())
          + " | K1-K9 and KP launched by each step's cold call: " + "; ".join(
              f"{k}: {v or 'none'}" for k, v in launched.items())
          + f" | demos {t_demos:.1f} s, phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)


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
    n_part = phase_partition_kernel(errs)
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
          f"KP bitwise equal to _tile_rows on {n_part} CSRs; "
          f"max|err| " + ", ".join(
              f"{k}={v:.3e}" for k, v in errs.items())
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    # 4. main path; 5. launch counts
    from graphblas_tpu_torch.kernels import sortreduce as SRD
    from graphblas_tpu_torch.kernels import spmv_onehot as OH
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    from graphblas_tpu_torch.utils import native as NAT
    rng = np.random.default_rng(3)
    reset_kernel_launches()
    states = {label: main_path(label, S, rng) for label, S in graphs.items()}
    counts = {"K2": OH.launches, "K1": SPR.launches["spmv_route"],
              "K3": SPR.launches["spmv_route_monoid"],
              "K4": SPR.launches["spmv_route_ds"],
              "K9": sum(st["k9"] for st in states.values()),
              "KP": SPR.launches["spmv_partition"]}
    print("[5 launches] " + ", ".join(
        f"{KERNELS[k][0]}={v}" for k, v in counts.items()), flush=True)
    assert all(v > 0 for v in counts.values()), counts
    # 6. times
    times = {label: phase_times(label, st, card, errs)
             for label, st in states.items()}
    gather_wall(states[next(iter(states))], card)
    ta = times[next(iter(times))]
    ta["KP"] = partition_times(card, errs)
    graph_b = graphs["b (RMAT-20 x16)"]      # phase 14's graph
    del states, times, graphs
    # 7. SpGEMM main path, sort-reduce launch counts
    reset_kernel_launches()
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
    # 13. K9 (its launches in the kernels line are the main path's)
    _, ta["K9"] = phase_permute(card, errs)
    # 14. eWise, pending events, unsigned arithmetic, the GrB algorithms
    ewise_path(graph_b, card)
    # 15. the rest of the op layer and the operator sugar
    op_layer_path(graph_b, card)
    # 16. the distributed tier on a world-size-1 NCCL group
    dist_path(graph_b, card)
    # 17. the demos, GxB_BF16, the user algebra, threads
    surface_path(graph_b, card)
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
