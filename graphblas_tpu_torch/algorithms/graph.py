"""Graph algorithms on the op layer (counterpart of
``graphblas_tpu.algorithms.graph``; LAGraph-style drivers, BASELINE.json
configs: BFS lor-land vxm, PageRank plus-times SpMV iteration, triangle
counting by masked SpGEMM, SSSP min-plus relaxation; BFS parents by a
positional MIN_FIRSTJ vxm, connected components by FastSV).

Two tiers per algorithm, as in the JAX package:
  * GrB tier — composed from the public ops (vxm/apply/reduce).
  * fused tier — a loop over the raw CSR arrays.  With a plan (built by
    ``optimize=True``, or kept with A's arrays by the one plan cache,
    kernels/spmv_route.py ``plan_for``) each step is one planned SpMV
    kernel launch; without one it is plain torch.

The fused loops test their stopping condition on the host once per step
(the JAX package compiles them into one while_loop); capturing them in a
CUDA graph would remove that sync.  Each test is one
``config.blocking_copy`` (counted ``host_syncs``); the source's start value
is a ``fill_`` of one element, not an indexed store (which copies a host
scalar to the card and waits).

Spans (``config.timed``): a root span per fused entry point
(``algorithms.sssp``, ``.pagerank_fused``, ``.bfs_levels_fused``,
``.connected_components``) and for ``bfs_parents``, one per host-checked
batch of a loop (``algorithms.sssp.batch``, ``.pagerank.step``,
``.bfs.batch``, ``.bfs_parents.level``) and one per plan lookup
(``algorithms.pattern_plan``, ``.sssp_plan``).
"""

from __future__ import annotations

import math

import torch

from ..core import config as CFG
from ..core import monoid as MON
from ..core import ops as OPS
from ..core import semiring as SR
from ..core import types as T
from ..core.descriptor import Descriptor
from ..core.matrix import BITMAP, COL, ROW, SPARSE, Matrix, Vector
from ..kernels import segment as K
from ..kernels import spmv_route as SPRT
from ..utils.tensor_cache import TensorCache

@CFG.timed("algorithms.pattern_plan")
def _pattern_route_plan(At: Matrix, build: bool):
    """Plan for y = A'x on the pattern of A (At = A in CSC = A' in CSR):
    lor-land is sum > 0, PageRank's contributions are sums of w[i]."""
    if not CFG.GLOBAL.kernels_enabled:
        return None
    return SPRT.plan_for(At.indptr, At.indices, None,
                         (At.shape[1], At.shape[0]), build, kind="pattern")


# ---------------------------------------------------------------------------
# BFS
# ---------------------------------------------------------------------------

def bfs_levels(A: Matrix, source: int) -> Vector:
    """Level-synchronous BFS via masked lor-land vxm (BASELINE.json config
    1).  Returns int32 levels (source = 0); absent = unreached."""
    from .. import api
    n = A.nrows
    levels = Vector.new(T.INT32, n, fmt=BITMAP, device=A.device)
    frontier = Vector.new(T.BOOL, n, fmt=BITMAP, device=A.device)
    frontier.bitmap[source, 0] = True
    frontier.values[source, 0] = True
    depth = 0
    nvisited = 0
    while True:
        # levels<frontier> = depth
        lv, lp = levels.to_dense_pair()
        fv, fp = frontier.to_dense_pair()
        fb = fp & (fv != 0)
        lv = torch.where(fb, torch.full_like(lv, depth), lv)
        lp = lp | fb
        levels.values, levels.bitmap = lv, lp
        levels._nvals_cache = None
        now = int(lp.sum())
        if now == nvisited:
            break
        nvisited = now
        # frontier = (frontier' lor.land A) masked by !visited
        frontier = api.vxm(frontier, A, SR.LOR_LAND, mask=levels,
                           desc=Descriptor(mask_complement=True,
                                           mask_structure=True,
                                           replace=True))
        depth += 1
    return levels


def _routed_bfs(n: int, source: int, plan) -> torch.Tensor:
    """BFS over a pattern plan: nxt = (A' f) > 0, exact for lor-land since
    a positive fp32 sum never rounds to zero.  Four levels per host
    check, as in the JAX runner (levels past the last frontier are
    no-ops)."""
    dev = plan.device
    levels = torch.full((n,), -1, dtype=torch.int32, device=dev)
    levels.narrow(0, source, 1).fill_(0)
    f = torch.zeros(n, dtype=torch.float32, device=dev)
    f.narrow(0, source, 1).fill_(1.0)
    depth = 0
    while True:
        with CFG.timed("algorithms.bfs.batch"):
            for _ in range(4):
                nxt = (SPRT.spmv_route(f, plan) > 0) & (levels < 0)
                depth += 1
                levels = torch.where(nxt, torch.full_like(levels, depth),
                                     levels)
                f = nxt.to(torch.float32)
            more = bool(CFG.blocking_copy((f > 0).any(), "cpu"))
        if not more:
            return levels


def _bfs_fused_plain(indptr, indices, source: int, n: int) -> torch.Tensor:
    nnz = int(indices.shape[0])
    rows = K.expand_rowids(indptr, nnz, n).long()
    cols = indices.long()
    levels = torch.full((n,), -1, dtype=torch.int32, device=indptr.device)
    levels.narrow(0, source, 1).fill_(0)
    frontier = torch.zeros(n, dtype=torch.bool, device=indptr.device)
    frontier.narrow(0, source, 1).fill_(True)
    depth = 0
    while bool(CFG.blocking_copy(frontier.any(), "cpu")):
        # next[j] = OR over edges (i, j) of frontier[i] — scatter-or
        nxt = torch.zeros(n, dtype=torch.bool, device=indptr.device)
        nxt[cols[frontier[rows]]] = True
        nxt &= levels < 0
        depth += 1
        levels = torch.where(nxt, torch.full_like(levels, depth), levels)
        frontier = nxt
    return levels


@CFG.timed("algorithms.bfs_levels_fused")
def bfs_levels_fused(A: Matrix, source: int, optimize=False) -> torch.Tensor:
    """BFS levels as an int32 tensor (-1 = unreached).  With a plan
    (``optimize=True`` or already cached) each level is one planned SpMV
    on A's pattern."""
    At = A.to_format(SPARSE, COL)
    plan = _pattern_route_plan(At, build=optimize)
    if plan is not None:
        return _routed_bfs(A.nrows, int(source), plan)
    Ar = A.to_format(SPARSE, ROW)
    return _bfs_fused_plain(Ar.indptr, Ar.indices, int(source), A.nrows)


def bfs_parents(A: Matrix, source: int) -> Vector:
    """BFS parent tree via MIN_FIRSTJ vxm (the positional semiring of the
    reference's GxB_MIN_FIRSTJ_INT64 BFS idiom): each step the frontier's
    unvisited out-neighbours (a complemented structural mask with replace)
    take the least frontier vertex as parent.  Returns an INT64 Vector,
    parent[source] = source, absent where unreached.  Each level's
    ``frontier.nvals`` is one ``host_syncs``."""
    from .. import api
    n, dev, source = A.nrows, A.device, int(source)
    with CFG.timed("algorithms.bfs_parents", dev):
        vals = torch.zeros((n, 1), dtype=torch.int64, device=dev)
        vals.narrow(0, source, 1).fill_(source)
        present = torch.zeros((n, 1), dtype=torch.bool, device=dev)
        present.narrow(0, source, 1).fill_(True)
        parents = Vector.from_dense_masked(vals, present)
        frontier = Vector.from_dense_masked(vals, present)
        d = Descriptor(mask_complement=True, mask_structure=True,
                       replace=True)
        while True:
            with CFG.timed("algorithms.bfs_parents.level", dev):
                CFG.count("bfs_parents.levels")
                frontier = api.vxm(frontier, A, SR.MIN_FIRSTJ, mask=parents,
                                   desc=d)
                if frontier.nvals == 0:
                    return parents
                parents = api.ewise_add(parents, frontier, OPS.SECOND,
                                        out_dtype=T.INT64)


# ---------------------------------------------------------------------------
# PageRank
# ---------------------------------------------------------------------------

def pagerank(A: Matrix, damping=0.85, tol=1e-6, max_iter=100) -> Vector:
    """PageRank via the GrB op layer (plus-times vxm iteration;
    BASELINE.json config 2), in FP64 as in the JAX package.  Returns a
    dense Vector."""
    from .. import api
    n = A.nrows
    outdeg = api.reduce(api.apply(A, OPS.ONE, out_dtype=T.FP64), MON.PLUS)
    dv, dp = outdeg.to_dense_1d()
    dv = torch.where(dp, dv, torch.ones_like(dv))  # dangling: no div0
    r = Vector.from_dense(torch.full((n,), 1.0 / n, dtype=torch.float64,
                                     device=A.device))
    teleport = (1.0 - damping) / n
    for _ in range(max_iter):
        r0 = r.values[:, 0]
        w = Vector.from_dense(r0 / dv)
        rn = api.vxm(w, A, SR.PLUS_TIMES)
        rv, rp = rn.to_dense_1d()
        rv = damping * torch.where(rp, rv, torch.zeros_like(rv)) + teleport
        # dangling mass redistributed uniformly
        dangling = torch.where(dp, torch.zeros_like(r0), r0).sum()
        rv = rv + damping * dangling / n
        delta = float((rv - r0).abs().sum())
        r = Vector.from_dense(rv)
        if delta < tol:
            break
    return r


def _pagerank_loop(step, r, tol, max_iter):
    if tol <= 0:
        for _ in range(max_iter):
            with CFG.timed("algorithms.pagerank.step"):
                r = step(r)
        return r, max_iter
    it = 0
    delta = math.inf
    while it < max_iter and delta > tol:
        with CFG.timed("algorithms.pagerank.step"):
            rn = step(r)
            delta = float(CFG.blocking_copy((rn - r).abs().sum(), "cpu"))
        r = rn
        it += 1
    return r, it


@CFG.timed("algorithms.pagerank_fused")
def pagerank_fused(A: Matrix, damping=0.85, tol=1e-6, max_iter=100,
                   optimize=False):
    """FP32 PageRank over A's CSC arrays; returns (r, iterations).  With a
    plan each step's SpMV is one planned kernel launch."""
    n = A.nrows
    Ar = A.to_format(SPARSE, ROW)
    outdeg = torch.diff(Ar.indptr).to(torch.float32)
    At = A.to_format(SPARSE, COL)  # A in CSC == A' in CSR
    safe_deg = torch.where(outdeg > 0, outdeg, torch.ones_like(outdeg))
    dangling_mask = outdeg > 0
    teleport = (1.0 - damping) / n
    plan = _pattern_route_plan(At, build=optimize)
    if plan is not None:
        def spmv(w):
            return SPRT.spmv_route(w, plan)
    else:
        nnz = int(At.indices.shape[0])
        segs = K.expand_rowids(At.indptr, nnz, n).long()
        srcs = At.indices.long()

        def spmv(w):
            return torch.zeros_like(w).index_add_(0, segs, w[srcs])

    def step(r):
        rn = spmv(r / safe_deg)
        dangling = torch.where(dangling_mask, torch.zeros_like(r), r).sum()
        return damping * (rn + dangling / n) + teleport

    r0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=A.device)
    return _pagerank_loop(step, r0, tol, max_iter)


# ---------------------------------------------------------------------------
# Triangle counting
# ---------------------------------------------------------------------------

_tc_cache = TensorCache(4)
# LAGraph's presort rule (LAGr_TriangleCount, AutoSort): relabel by degree
# when there are more than this many vertices, the mean degree is at least
# SORT_MEAN and more than SORT_SKEW times the median (LAGraph samples 1000
# degrees; here all are counted)
SORT_MIN_N = 1000
SORT_MEAN = 10
SORT_SKEW = 4


def _degree_ordered(L: Matrix) -> Matrix:
    """``L`` (strictly lower, by row) with its vertices relabelled in
    ascending order of degree, or ``L`` itself where the degrees are not
    skewed (LAGraph's rule above).

    sum((L L') .* L) counts each triangle of the undirected graph whose
    edges are L's entries once, at its highest-labelled vertex, whatever
    the labels: so the relabelled L, each edge stored at its
    higher-ranked end, gives the same count.  With ascending degree ranks
    (LAGraph's presort for this method; GAP's tc relabels likewise) the
    product's pivot, a triangle's lowest-ranked vertex, has few
    higher-ranked neighbours: L L' expands far fewer products on a
    power-law graph (2.47e9 against 2.43e10 on a Graph500 Kronecker graph
    of scale 20)."""
    n = L.nrows
    nnz = L.nvals
    if L.ncols != n or n <= SORT_MIN_N or 2 * nnz < SORT_MEAN * n:
        return L
    Lr = L.to_format(SPARSE, ROW)
    rows = K.expand_rowids(Lr.indptr, nnz, n).long()
    cols = Lr.indices.long()
    deg = torch.bincount(rows, minlength=n) + torch.bincount(cols, minlength=n)
    median = int(CFG.blocking_copy(deg.median(), "cpu"))
    if 2 * nnz <= SORT_SKEW * n * median:       # mean 2 nnz / n
        return L
    CFG.count("tc.degree_sorts")
    order = torch.argsort(deg * n + torch.arange(n, device=deg.device))
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=deg.device)
    a, b = rank[rows], rank[cols]
    return Matrix.from_coo(torch.maximum(a, b), torch.minimum(a, b),
                           Lr._vals_expanded(), (n, n), dtype=L.dtype,
                           orient=ROW, iso=L.iso)


def triangle_count(A: Matrix) -> int:
    """Sandia-style: ntri = sum(C) where C<L> = L*L' with plus_pair and
    L = tril(A, -1) (BASELINE.json config 3; reference idiom: masked dot3
    SpGEMM), L relabelled by degree where the degrees are skewed
    (``_degree_ordered``).  Rides the fused mxm + reduce of the SELL
    engine (the masked PAIR counter, no C materialised) when it applies,
    else the public mxm + reduce_scalar pair.

    L and L' are cached per input PATTERN while it lives
    (utils/tensor_cache.py): valid because PLUS_PAIR ignores values.
    Spans: ``algorithms.triangle_count`` (the call, with CUDA events on a
    card) and ``algorithms.triangle_count.prep`` (L and L' formed);
    counters ``tc.cache_hits`` / ``tc.cache_builds`` (the L, L' cache)
    and ``tc.degree_sorts``."""
    from .. import api
    from ..ops.mxm import mxm_reduce_scalar
    from ..ops.transpose import logical_transpose
    with CFG.timed("algorithms.triangle_count", A.device):
        pattern = [t for t in (A.indptr, A.h, A.indices, A.bitmap)
                   if t is not None]                 # none when A is full
        flags = (A.fmt, A.orient, tuple(A.shape))
        ent = _tc_cache.get(pattern, flags) if pattern else None
        if ent is None:
            CFG.count("tc.cache_builds")
            with CFG.timed("algorithms.triangle_count.prep", A.device):
                L = _degree_ordered(api.select(A, OPS.TRIL, -1))
                ent = (L, logical_transpose(L).to_format(SPARSE, ROW))
            if pattern:
                _tc_cache.put(pattern, flags, ent)
        else:
            CFG.count("tc.cache_hits")
        L, LT = ent
        d = Descriptor(mask_structure=True)
        acc = mxm_reduce_scalar(L, LT, SR.PLUS_PAIR, mask=L, desc=d)
        if acc is None:
            C = api.mxm(L, LT, SR.PLUS_PAIR, mask=L, desc=d,
                        out_dtype=T.INT64)
            acc = api.reduce_scalar(C, MON.PLUS, out_dtype=T.INT64)
        return int(CFG.blocking_copy(acc, "cpu"))


# ---------------------------------------------------------------------------
# SSSP (Bellman-Ford)
# ---------------------------------------------------------------------------

@CFG.timed("algorithms.sssp_plan")
def _sssp_route_plan(At: Matrix, build: bool):
    """Min-plus plan on A' over A's weights in fp32."""
    if not CFG.GLOBAL.kernels_enabled:
        return None
    return SPRT.plan_for(At.indptr, At.indices, At.values,
                         (At.shape[1], At.shape[0]), build, kind="fp32")


def _routed_sssp(n: int, source: int, plan) -> torch.Tensor:
    """Bellman-Ford over a min-plus plan (spmv_route_monoid), four
    relaxations per host check."""
    d = torch.full((n,), math.inf, dtype=torch.float32, device=plan.device)
    d.narrow(0, source, 1).fill_(0.0)
    it = 0
    while it < n + 4:
        with CFG.timed("algorithms.sssp.batch"):
            nd = d
            for _ in range(4):
                relax = SPRT.spmv_route_monoid(nd, plan, add="min",
                                               mul="plus")
                nd = torch.minimum(nd, relax)
            changed = bool(CFG.blocking_copy((nd < d).any(), "cpu"))
        d = nd
        it += 4
        if not changed:
            break
    return d


def _sssp_fused_plain(rows, cols, w, source: int, n: int,
                      max_iter: int) -> torch.Tensor:
    dist = torch.full((n,), math.inf, dtype=torch.float64, device=w.device)
    dist.narrow(0, source, 1).fill_(0.0)
    w = w.to(torch.float64)
    rows, cols = rows.long(), cols.long()
    it = 0
    changed = True
    while changed and it < max_iter:
        nd = dist.scatter_reduce(0, cols, dist[rows] + w, "amin",
                                 include_self=True)
        changed = bool(CFG.blocking_copy((nd < dist).any(), "cpu"))
        dist = nd
        it += 1
    return dist


@CFG.timed("algorithms.sssp")
def sssp(A: Matrix, source: int, max_iter: int | None = None,
         optimize=False) -> torch.Tensor:
    """Single-source shortest paths via Bellman-Ford over the min-plus
    semiring.  Returns fp64 distances, inf where unreachable.

    With ``optimize=True`` (or a cached plan) the relaxation runs through
    the planned min-plus kernel in fp32, as the JAX package's routed tier
    does (exact for integer weights below 2^24)."""
    At = A.to_format(SPARSE, COL)  # A in CSC == A' in CSR
    plan = _sssp_route_plan(At, build=optimize)
    if plan is not None:
        return _routed_sssp(A.nrows, int(source), plan).to(torch.float64)
    Ar = A.to_format(SPARSE, ROW)
    n = A.nrows
    rows = K.expand_rowids(Ar.indptr, int(Ar.indices.shape[0]), n)
    return _sssp_fused_plain(rows, Ar.indices, Ar._vals_expanded(),
                             int(source), n, max_iter or n)


def sssp_grb(A: Matrix, source: int) -> Vector:
    """GrB-tier SSSP: min-plus vxm relaxations through the public ops,
    each folded in by ewise_add MIN, until ``isequal`` sees no change.
    Returns an FP64 Vector, absent where unreached."""
    from .. import api
    n = A.nrows
    present = torch.arange(n, device=A.device) == source
    d = Vector.from_dense_masked(
        torch.zeros(n, dtype=torch.float64, device=A.device), present)
    while True:
        relaxed = api.vxm(d, A, SR.MIN_PLUS, out_dtype=T.FP64)
        nd = api.ewise_add(d, relaxed, OPS.MIN)
        if nd.isequal(d):
            return d
        d = nd


# ---------------------------------------------------------------------------
# Connected components (FastSV)
# ---------------------------------------------------------------------------

@CFG.timed("algorithms.connected_components")
def connected_components(A: Matrix) -> torch.Tensor:
    """Connected components via FastSV (LAGraph; min-hooking with pointer
    jumping), A taken as undirected: both directions of every edge.
    Returns int32 labels, each the least vertex id of its component."""
    Ar = A.to_format(SPARSE, ROW)
    n = A.nrows
    rows = K.expand_rowids(Ar.indptr, int(Ar.indices.shape[0]), n).long()
    return _cc_fastsv(rows, Ar.indices.long(), n)


def _cc_fastsv(rows, cols, n: int) -> torch.Tensor:
    """The JAX package's ``_cc_fused`` loop, its test on the host once a
    step: hook each edge's endpoints, their parents and themselves to the
    smaller grandparent, then shortcut (f = f[f]), until f is unchanged."""
    f = torch.arange(n, dtype=torch.int32, device=rows.device)
    while True:
        gf = f[f.long()]
        cand = torch.minimum(gf[rows], gf[cols])
        fn = f.clone()
        for tgt in (f[rows].long(), f[cols].long(), rows, cols):
            fn.scatter_reduce_(0, tgt, cand, "amin", include_self=True)
        fn = fn[fn.long()]
        if not bool(CFG.blocking_copy((fn != f).any(), "cpu")):
            return fn
        f = fn
