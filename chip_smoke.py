#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (graphblas_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line (more for the per-graph phases):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile graphblas_tpu_torch/csrc/spmv.cu with nvcc;
  3. kernels: every kernel instantiation against its plain torch version
     on the card, at small random sizes with empty rows and one row of
     10^5 nonzeros (exact for min/max, 1e-5*max|y| for fp32 plus,
     1e-12*max|y| for fp64);
  4. main path at real size through the public API on two graphs —
     (a) bench.py's uniform graph (n = 2^20, degree 16, seed 0) and
     (b) bench_real.rmat_edges(20, 16, seed 7), a power-law graph — with
     mxv/vxm (unplanned, planned with mask + accum, min-plus), the fp64
     planned SpMV, CSC conversion, PageRank, BFS and SSSP, each checked
     against scipy/numpy on the host;
  5. launch counts: every kernel of the path launched during phase 4;
  6. times: each kernel and its plain version at graphs (a) and (b)
     (CUDA events, median of 20 after warm-up).
The two lines before the last are the card (nvidia-smi) and one JSON
object describing the kernels; the last line is the result JSON.  Any
failure raises and exits non-zero.  Needs one CUDA card; exits non-zero
without one.
"""

import json
import subprocess
import sys
import time

import numpy as np

FP32_TOL = 1e-5      # fp32 plus: summation order differs
FP64_TOL = 1e-12
RELERR_GUARD = 1e-4  # bench.py's SpMV correctness guard
ADDS = ("plus", "min", "max")
MULS = ("times", "plus", "first", "second", "pair")
SOURCE = "graphblas_tpu_torch/csrc/spmv.cu"
KERNELS = {   # key: (name, TPU kernel replaced)
    "K2": ("spmv_rowwarp_f32", "graphblas_tpu/kernels/spmv_onehot.py:257"),
    "K1": ("spmv_planned<float,plus,times>",
           "graphblas_tpu/kernels/spmv_route.py:1446"),
    "K3": ("spmv_planned<float,{min,max,plus}x{times,plus,first,second,"
           "pair}>", "graphblas_tpu/kernels/spmv_route.py:1767"),
    "K4": ("spmv_planned<double,plus,times>",
           "graphblas_tpu/kernels/spmv_route.py:1581"),
}


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
            want = SPR._fold_extras(
                SPR.spmv_planned_plain(x, p, "plus", "times"), p, "plus")
            torch.cuda.synchronize()
            errs["K4"] = max(errs["K4"], max_err(got, want, "plus",
                                                 FP64_TOL))
            n_cmp += 1
            continue
        got = OH.spmv(ip, ix, v, x, S.shape[0])
        want = OH.spmv_plain(ip, ix, v, x, S.shape[0])
        torch.cuda.synchronize()
        errs["K2"] = max(errs["K2"], max_err(got, want, "plus", FP32_TOL))
        n_cmp += 1
        for add in ADDS:
            for mul in MULS:
                if (add, mul) == ("plus", "times"):
                    got, key = SPR.spmv_route(x, p), "K1"
                else:
                    got = SPR.spmv_route_monoid(x, p, add=add, mul=mul)
                    key = "K3"
                want = SPR._fold_extras(
                    SPR.spmv_planned_plain(x, p, add, mul), p, add)
                torch.cuda.synchronize()
                errs[key] = max(errs[key],
                                max_err(got, want, add, FP32_TOL))
                n_cmp += 1
    return n_cmp, S.shape, int(np.diff(S.indptr).max())


def bench_graph():
    """bench.py's graph: n = 2^20, degree 16, seed 0 (pattern values)."""
    import scipy.sparse as sps
    n, deg = 1 << 20, 16
    rng = np.random.default_rng(0)
    rows = rng.integers(0, n, n * deg).astype(np.int32)
    cols = rng.integers(0, n, n * deg).astype(np.int32)
    S = sps.csr_matrix((np.ones(n * deg, np.float32), (rows, cols)),
                       shape=(n, n))
    S.sum_duplicates()
    S.data[:] = 1.0
    return S


def rmat_graph():
    """bench_real.py's power-law graph: RMAT scale 20, edge factor 16,
    seed 7 (pattern values)."""
    import scipy.sparse as sps
    from bench_real import rmat_edges
    ri, ci, n = rmat_edges(20, 16, np.random.default_rng(7))
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


def phase_times(label, st, card, errs):
    """Phase 6: each kernel and its plain version at one graph."""
    import torch
    from graphblas_tpu_torch.kernels import spmv_onehot as OH
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    A, p32, p64 = st["A"], st["p32"], st["p64"]
    ip, ix, v = A.indptr, A.indices, A.values
    m = A.nrows
    nnz = int(ix.shape[0])
    x = torch.from_numpy(st["x"]).cuda()
    x64 = x.double()

    def plain(xx, p, add, mul):
        return SPR._fold_extras(SPR.spmv_planned_plain(xx, p, add, mul), p,
                                add)

    runs = {
        "K2": (lambda: OH.spmv(ip, ix, v, x, m),
               lambda: OH.spmv_plain(ip, ix, v, x, m), "plus", FP32_TOL),
        "K1": (lambda: SPR.spmv_route(x, p32),
               lambda: plain(x, p32, "plus", "times"), "plus", FP32_TOL),
        "K3": (lambda: SPR.spmv_route_monoid(x, p32, add="min", mul="plus"),
               lambda: plain(x, p32, "min", "plus"), "min", FP32_TOL),
        "K4": (lambda: SPR.spmv_route_ds(x64, p64),
               lambda: plain(x64, p64, "plus", "times"), "plus", FP64_TOL),
    }
    out = {}
    for key, (kern, ref, add, tol) in runs.items():
        got, want = kern(), ref()
        torch.cuda.synchronize()
        errs[key] = max(errs[key], max_err(got, want, add, tol))
        # turns: plain, kernel, kernel, plain; keep the medians' means
        tp1 = time_ms(ref)
        tk1 = time_ms(kern)
        tk2 = time_ms(kern)
        tp2 = time_ms(ref)
        out[key] = ((tk1 + tk2) / 2, (tp1 + tp2) / 2)
    print(f"[6 times {label}] {card} | nnz={nnz} | " + " | ".join(
        f"{KERNELS[k][0]}: {t:.3f} ms ({nnz / t / 1e6:.2f} Gnnz/s), plain "
        f"{tp:.3f} ms ({nnz / tp / 1e6:.2f} Gnnz/s)"
        for k, (t, tp) in out.items()), flush=True)
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # 1. device
    card = card_line()
    print(f"[1 device] {card} | {torch.cuda.get_device_name(0)} | "
          f"count={torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    # 2. build
    from graphblas_tpu_torch.kernels import _cuda
    t0 = time.perf_counter()
    so = _cuda.build()
    _cuda.lib()
    regs = [ln.strip() for ln in _cuda.build_log().splitlines()
            if "registers" in ln]
    print(f"[2 build] {time.perf_counter() - t0:.1f} s -> {so.name}; "
          f"ptxas: {len(regs)} kernels, "
          f"{max((ln for ln in regs), key=len, default='')}", flush=True)
    # 3. kernels vs plain versions
    errs = {k: 0.0 for k in KERNELS}
    t0 = time.perf_counter()
    n_cmp, shape, max_row = phase_kernels(errs)
    print(f"[3 kernels] {n_cmp} instantiations match their plain versions "
          f"(min/max exact, fp32 plus <= {FP32_TOL}*max|y|, fp64 <= "
          f"{FP64_TOL}*max|y|) at {shape[0]}x{shape[1]}, max row "
          f"{max_row}; max|err| " + ", ".join(
              f"{k}={v:.3e}" for k, v in errs.items())
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)
    # 4. main path; 5. launch counts
    from graphblas_tpu_torch.kernels import spmv_onehot as OH
    from graphblas_tpu_torch.kernels import spmv_route as SPR
    rng = np.random.default_rng(3)
    graphs = {"a (bench.py uniform 2^20 x16)": bench_graph(),
              "b (RMAT-20 x16)": rmat_graph()}
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
    ta = times[next(iter(times))]
    # 7. result lines
    print(card_line())
    print(json.dumps({"kernels": [
        {"name": KERNELS[k][0], "route": "cuda", "source": SOURCE,
         "replaces": KERNELS[k][1], "launches": counts[k],
         "max_abs_err": errs[k], "ms": ta[k][0], "plain_ms": ta[k][1]}
        for k in ("K1", "K2", "K3", "K4")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
