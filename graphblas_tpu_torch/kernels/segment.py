"""Vectorized sparse primitives in plain torch (counterpart of
``graphblas_tpu.kernels.segment``, which is plain jnp, not Pallas).

The reference parallelizes with task lists over OpenMP threads
(Source/GB_ek_slice.c); here the same work items are whole-array torch
programs: row-id expansion replaces ek_slice, segmented reductions
(``index_add_`` / ``scatter_reduce_`` for the built-in monoids, a
segmented Hillis-Steele scan for any other associative operator) replace
the reduction templates.  Ops with data-dependent output sizes take one
host sync of the count, as the JAX package does.
"""

from __future__ import annotations

import torch

from ..core import types as T
from ..core.monoid import Monoid

KEY = torch.int64  # combined (vec, idx) sort key: vec * veclen + idx


def expand_rowids(indptr: torch.Tensor, nnz: int, nvec: int) -> torch.Tensor:
    """Vector id of each stored entry, from the CSR/CSC pointer array."""
    if nnz == 0:
        return torch.zeros(0, dtype=indptr.dtype, device=indptr.device)
    if nvec == 0:
        return torch.zeros(nnz, dtype=indptr.dtype, device=indptr.device)
    counts = torch.diff(indptr).long()
    ids = torch.arange(nvec, dtype=indptr.dtype, device=indptr.device)
    return torch.repeat_interleave(ids, counts, output_size=nnz)


def histogram_sorted(vec_ids: torch.Tensor, nvec: int,
                     weights=None) -> torch.Tensor:
    """Per-id counts (int64).  Ids beyond nvec-1 land in an extra bucket
    that is sliced off."""
    ids = torch.clamp(vec_ids.long(), max=nvec)
    w = (torch.ones(ids.shape[0], dtype=torch.int64, device=ids.device)
         if weights is None else weights.long())
    out = torch.zeros(nvec + 1, dtype=torch.int64, device=ids.device)
    return out.index_add_(0, ids, w)[:nvec]


def indptr_from_sorted(vec_ids: torch.Tensor, nvec: int,
                       dtype=torch.int32) -> torch.Tensor:
    """indptr from sorted vector ids (reference: Source/GB_builder.c
    step 4)."""
    counts = histogram_sorted(vec_ids, nvec)
    out = torch.zeros(nvec + 1, dtype=torch.int64, device=vec_ids.device)
    torch.cumsum(counts, 0, out=out[1:])
    return out.to(dtype)


def make_key(vec_ids, idx, veclen: int) -> torch.Tensor:
    return vec_ids.to(KEY) * veclen + idx.to(KEY)


def key_split(keys, veclen: int):
    return ((keys // veclen).to(torch.int32),
            (keys % veclen).to(torch.int32))


# ---------------------------------------------------------------------------
# segmented reduction
# ---------------------------------------------------------------------------

def _check_arith(vals: torch.Tensor) -> None:
    if vals.dtype in T.UNSIGNED_WIDE:
        raise NotImplementedError(
            f"arithmetic on {vals.dtype} is not supported yet "
            "(torch has no kernels for it; see ROADMAP)")


def _expand_index(seg: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    if vals.dim() == 1:
        return seg
    return seg.view((-1,) + (1,) * (vals.dim() - 1)).expand_as(vals)


def _scatter(vals, seg, num_segments, init, reduce):
    out = torch.full((num_segments,) + tuple(vals.shape[1:]), init,
                     dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, _expand_index(seg, vals), vals, reduce,
                               include_self=True)


def segment_reduce(vals: torch.Tensor, seg_ids: torch.Tensor,
                   num_segments: int, monoid: Monoid,
                   indices_are_sorted: bool = True) -> torch.Tensor:
    """Reduce ``vals`` (first axis) by segment under an arbitrary monoid.
    Empty segments get the monoid identity."""
    ty = T.lookup(vals.dtype)
    ident = monoid.identity_tensor(ty, vals.device)
    tail = tuple(vals.shape[1:])
    if vals.shape[0] == 0:
        return ident.expand((num_segments,) + tail).clone()
    seg = seg_ids.long()
    name = monoid.op.name
    if ty.is_bool and name in ("GrB_PLUS", "GrB_MAX"):
        # boolean arithmetic collapses: plus == max == lor on bool
        name = "GrB_LOR"
    elif ty.is_bool and name in ("GrB_TIMES", "GrB_MIN"):
        name = "GrB_LAND"
    if name == "GrB_PLUS":
        _check_arith(vals)
        out = torch.zeros((num_segments,) + tail, dtype=vals.dtype,
                          device=vals.device)
        return out.index_add_(0, seg, vals)
    if name == "GrB_TIMES":
        _check_arith(vals)
        return _scatter(vals, seg, num_segments, 1, "prod")
    if name in ("GrB_MIN", "GrB_MAX"):
        _check_arith(vals)
        if vals.is_floating_point():
            # scatter amin/amax propagate NaN; GraphBLAS MIN/MAX are
            # omitnan — substitute the identity for NaN inputs first
            vals = torch.where(torch.isnan(vals), ident, vals)
        return _scatter(vals, seg, num_segments, ident.item(),
                        "amin" if name == "GrB_MIN" else "amax")
    if name in ("GrB_LOR", "GrB_LAND", "GrB_LXOR"):
        nz = (vals != 0).to(torch.int32)
        if name == "GrB_LOR":
            r = _scatter(nz, seg, num_segments, 0, "amax") > 0
        elif name == "GrB_LAND":
            r = _scatter(nz, seg, num_segments, 1, "amin") > 0
        else:
            r = (torch.zeros((num_segments,) + tail, dtype=torch.int32,
                             device=vals.device).index_add_(0, seg, nz)
                 % 2) > 0
        return r.to(vals.dtype)
    if name == "GxB_ANY":
        # deterministic "any": the max, for reproducibility
        if ty.is_bool:
            return _scatter(vals.to(torch.int32), seg, num_segments, 0,
                            "amax") > 0
        return _scatter(vals, seg, num_segments,
                        torch.finfo(vals.dtype).min if vals.is_floating_point()
                        else torch.iinfo(vals.dtype).min, "amax")
    # ---- generic path: segmented inclusive scan (Hillis-Steele) ----------
    if not indices_are_sorted:
        order = torch.argsort(seg, stable=True)
        seg, vals = seg[order], vals[order]
    n = vals.shape[0]
    flags = torch.ones(n, dtype=torch.bool, device=vals.device)
    flags[1:] = seg[1:] != seg[:-1]
    op = monoid.op.fn
    v, f = vals, flags
    k = 1
    while k < n:
        nv = v.clone()
        fk = f[k:].view((-1,) + (1,) * (v.dim() - 1))
        nv[k:] = torch.where(fk, v[k:], op(v[:-k], v[k:]).to(v.dtype))
        nf = f.clone()
        nf[k:] = f[k:] | f[:-k]
        v, f = nv, nf
        k *= 2
    is_last = torch.ones(n, dtype=torch.bool, device=vals.device)
    is_last[:-1] = seg[1:] != seg[:-1]
    out = ident.expand((num_segments,) + tail).clone()
    out[seg[is_last]] = v[is_last]
    return out


def full_reduce(vals: torch.Tensor, monoid: Monoid, dtype=None
                ) -> torch.Tensor:
    """Reduce a whole array under a monoid (GrB_reduce to scalar); returns
    a 0-d tensor."""
    ty = T.lookup(dtype) if dtype is not None else T.lookup(vals.dtype)
    vals = T.cast(vals.reshape(-1), ty)
    ident = monoid.identity_tensor(ty, vals.device)
    if vals.shape[0] == 0:
        return ident
    name = monoid.op.name
    if ty.is_bool and name in ("GrB_PLUS", "GrB_MAX"):
        name = "GrB_LOR"
    elif ty.is_bool and name in ("GrB_TIMES", "GrB_MIN"):
        name = "GrB_LAND"
    if name == "GrB_PLUS":
        _check_arith(vals)
        return vals.sum(dtype=ty.torch_dtype)
    if name == "GrB_TIMES":
        _check_arith(vals)
        return vals.prod(dtype=ty.torch_dtype)
    if name in ("GrB_MIN", "GrB_MAX"):
        _check_arith(vals)
        if vals.is_floating_point():
            vals = torch.where(torch.isnan(vals), ident, vals)
        return vals.amin() if name == "GrB_MIN" else vals.amax()
    if name == "GrB_LOR":
        return (vals != 0).any().to(ty.torch_dtype)
    if name == "GrB_LAND":
        return (vals != 0).all().to(ty.torch_dtype)
    if name == "GrB_LXOR":
        return ((vals != 0).sum() % 2).to(ty.torch_dtype)
    if name == "GxB_ANY":
        return vals.amax()
    seg = torch.zeros(vals.shape[0], dtype=torch.int64, device=vals.device)
    return segment_reduce(vals, seg, 1, monoid)[0]


# ---------------------------------------------------------------------------
# sorting / building
# ---------------------------------------------------------------------------

def sort_coo(vec_ids, idx, veclen: int):
    """Stable sort of COO entries by (vec, idx); returns (order,
    sorted_keys) (reference: Source/GB_builder.c step 2)."""
    keys = make_key(vec_ids, idx, veclen)
    skeys, order = torch.sort(keys, stable=True)
    return order, skeys


def sort_with_payload(keys, vals):
    """(sorted keys, correspondingly permuted vals), stable."""
    skeys, order = torch.sort(keys, stable=True)
    return skeys, vals[order]


# ---------------------------------------------------------------------------
# two-phase (symbolic/numeric) helpers — host syncs the count
# ---------------------------------------------------------------------------

def group_ids(sorted_keys):
    """(group id per element, number of groups as a host int)."""
    n = sorted_keys.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64,
                           device=sorted_keys.device), 0
    is_new = torch.ones(n, dtype=torch.int64, device=sorted_keys.device)
    is_new[1:] = (sorted_keys[1:] != sorted_keys[:-1]).long()
    gid = torch.cumsum(is_new, 0) - 1
    return gid, int(gid[-1]) + 1


def compact(mask, *arrays):
    """Keep elements where mask; returns (count, kept arrays).  The
    zombie-free deletion path (reference: GB_selector in GB_wait.c)."""
    idx = torch.nonzero(mask).reshape(-1)
    return int(idx.shape[0]), tuple(a[idx] for a in arrays)


def lookup_sorted(sorted_keys, queries):
    """(found, pos) of each query in a sorted key array (reference:
    Source/Shared/GB_hyper_hash_lookup.h)."""
    n = sorted_keys.shape[0]
    if n == 0:
        return (torch.zeros(queries.shape, dtype=torch.bool,
                            device=queries.device),
                torch.zeros(queries.shape, dtype=torch.int64,
                            device=queries.device))
    pos = torch.searchsorted(sorted_keys, queries)
    safe = torch.clamp(pos, max=n - 1)
    found = (pos < n) & (sorted_keys[safe] == queries)
    return found, safe
