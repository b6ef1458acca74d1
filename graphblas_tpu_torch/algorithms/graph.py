"""Graph algorithms on the op layer (counterpart of
``graphblas_tpu.algorithms.graph``; LAGraph-style drivers, BASELINE.json
configs: BFS lor-land vxm, PageRank plus-times SpMV iteration, triangle
counting by masked SpGEMM, SSSP min-plus relaxation).

Two tiers per algorithm, as in the JAX package:
  * GrB tier — composed from the public ops (vxm/apply/reduce).
  * fused tier — a loop over the raw CSR arrays.  With a plan (built by
    ``optimize=True`` or cached) each step is one planned SpMV kernel
    launch (kernels/spmv_route.py); without one it is plain torch.

The fused loops test their stopping condition on the host once per step
(the JAX package compiles them into one while_loop); capturing them in a
CUDA graph would remove that sync.
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

# pattern-SpMV plans per adjacency structure (values replaced by 1.0 so
# the plus-times kernel computes the pattern semirings exactly: lor-land
# frontier expansion is sum>0, PageRank contributions are sums of w[i])
_pattern_plans: dict = {}


def _pattern_route_plan(At: Matrix, build: bool):
    """Plan for y = A'x on the pattern of A (At = A in CSC = A' in CSR),
    cached per structure with identity re-checks."""
    if not CFG.GLOBAL.kernels_enabled:
        return None
    key = (id(At.indptr), id(At.indices), At.shape)
    ent = _pattern_plans.get(key)
    if ent is not None and ent[0] is At.indptr and ent[1] is At.indices:
        return ent[2]
    if not build:
        return None
    ones = torch.ones(At.indices.shape[0], dtype=torch.float32,
                      device=At.device)
    plan = SPRT.build_plan(At.indptr, At.indices, ones,
                           (At.shape[1], At.shape[0]))
    if len(_pattern_plans) > 4:
        _pattern_plans.clear()
    _pattern_plans[key] = (At.indptr, At.indices, plan)
    return plan


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
    levels[source] = 0
    f = torch.zeros(n, dtype=torch.float32, device=dev)
    f[source] = 1.0
    depth = 0
    while True:
        for _ in range(4):
            nxt = (SPRT.spmv_route(f, plan) > 0) & (levels < 0)
            depth += 1
            levels = torch.where(nxt, torch.full_like(levels, depth), levels)
            f = nxt.to(torch.float32)
        if not bool((f > 0).any()):
            return levels


def _bfs_fused_plain(indptr, indices, source: int, n: int) -> torch.Tensor:
    nnz = int(indices.shape[0])
    rows = K.expand_rowids(indptr, nnz, n).long()
    cols = indices.long()
    levels = torch.full((n,), -1, dtype=torch.int32, device=indptr.device)
    levels[source] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=indptr.device)
    frontier[source] = True
    depth = 0
    while bool(frontier.any()):
        # next[j] = OR over edges (i, j) of frontier[i] — scatter-or
        nxt = torch.zeros(n, dtype=torch.bool, device=indptr.device)
        nxt[cols[frontier[rows]]] = True
        nxt &= levels < 0
        depth += 1
        levels = torch.where(nxt, torch.full_like(levels, depth), levels)
        frontier = nxt
    return levels


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
            r = step(r)
        return r, max_iter
    it = 0
    delta = math.inf
    while it < max_iter and delta > tol:
        rn = step(r)
        delta = float((rn - r).abs().sum())
        r = rn
        it += 1
    return r, it


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


def triangle_count(A: Matrix) -> int:
    """Sandia-style: ntri = sum(C) where C<L> = L*L' with plus_pair and
    L = tril(A, -1) (BASELINE.json config 3; reference idiom: masked dot3
    SpGEMM).  Rides the fused mxm + reduce of the SELL engine (the
    masked PAIR counter, no C materialised) when it applies, else the
    public mxm + reduce_scalar pair.

    L and L' are cached per input PATTERN while it lives
    (utils/tensor_cache.py): valid because PLUS_PAIR ignores values."""
    from .. import api
    from ..ops.mxm import mxm_reduce_scalar
    from ..ops.transpose import logical_transpose
    pattern = [t for t in (A.indptr, A.h, A.indices, A.bitmap)
               if t is not None]                 # none when A is full
    flags = (A.fmt, A.orient, tuple(A.shape))
    ent = _tc_cache.get(pattern, flags) if pattern else None
    if ent is None:
        L = api.select(A, OPS.TRIL, -1)
        ent = (L, logical_transpose(L).to_format(SPARSE, ROW))  # L' too
        if pattern:
            _tc_cache.put(pattern, flags, ent)
    L, LT = ent
    d = Descriptor(mask_structure=True)
    acc = mxm_reduce_scalar(L, LT, SR.PLUS_PAIR, mask=L, desc=d)
    if acc is not None:
        return int(acc)
    C = api.mxm(L, LT, SR.PLUS_PAIR, mask=L, desc=d, out_dtype=T.INT64)
    return int(api.reduce_scalar(C, MON.PLUS, out_dtype=T.INT64))


# ---------------------------------------------------------------------------
# SSSP (Bellman-Ford)
# ---------------------------------------------------------------------------

_sssp_plans: dict = {}


def _sssp_route_plan(At: Matrix, build: bool):
    """Min-plus plan on A' (values kept, unlike the pattern plans), cached
    per structure identity."""
    if not CFG.GLOBAL.kernels_enabled:
        return None
    key = (id(At.indptr), id(At.indices), id(At.values), At.shape)
    ent = _sssp_plans.get(key)
    if ent is not None and ent[0] is At.indptr and ent[1] is At.indices:
        return ent[3]
    if not build:
        return None
    vals = T.cast(At._vals_expanded(), T.FP32).contiguous()
    plan = SPRT.build_plan(At.indptr, At.indices, vals,
                           (At.shape[1], At.shape[0]))
    if len(_sssp_plans) > 4:
        _sssp_plans.clear()
    _sssp_plans[key] = (At.indptr, At.indices, At.values, plan)
    return plan


def _routed_sssp(n: int, source: int, plan) -> torch.Tensor:
    """Bellman-Ford over a min-plus plan (spmv_route_monoid), four
    relaxations per host check."""
    d = torch.full((n,), math.inf, dtype=torch.float32, device=plan.device)
    d[source] = 0.0
    it = 0
    while it < n + 4:
        nd = d
        for _ in range(4):
            relax = SPRT.spmv_route_monoid(nd, plan, add="min", mul="plus")
            nd = torch.minimum(nd, relax)
        changed = bool((nd < d).any())
        d = nd
        it += 4
        if not changed:
            break
    return d


def _sssp_fused_plain(rows, cols, w, source: int, n: int,
                      max_iter: int) -> torch.Tensor:
    dist = torch.full((n,), math.inf, dtype=torch.float64, device=w.device)
    dist[source] = 0.0
    w = w.to(torch.float64)
    rows, cols = rows.long(), cols.long()
    it = 0
    changed = True
    while changed and it < max_iter:
        nd = dist.scatter_reduce(0, cols, dist[rows] + w, "amin",
                                 include_self=True)
        changed = bool((nd < dist).any())
        dist = nd
        it += 1
    return dist


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
