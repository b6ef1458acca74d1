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

# PLUS reductions of BF16 add in float32 and round once (types.BF16)
ACC = {torch.bfloat16: torch.float32}


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
    Empty segments get the monoid identity, but under ANY (a max from the
    type's minimum) that minimum, an empty ``vals`` included."""
    ty = T.lookup(vals.dtype)
    ident = monoid.identity_tensor(ty, vals.device)
    tail = tuple(vals.shape[1:])
    name = monoid.op.name
    if vals.shape[0] == 0 and (name != "GxB_ANY" or ty.is_struct):
        return ident.expand((num_segments,) + tail).clone()
    seg = seg_ids.long()
    if T.wide_unsigned(ty):
        return _segment_reduce_unsigned(vals, seg, num_segments, monoid,
                                        ident, indices_are_sorted)
    if ty.is_bool and name in ("GrB_PLUS", "GrB_MAX"):
        # boolean arithmetic collapses: plus == max == lor on bool
        name = "GrB_LOR"
    elif ty.is_bool and name in ("GrB_TIMES", "GrB_MIN"):
        name = "GrB_LAND"
    if name == "GrB_PLUS":
        acc = ACC.get(vals.dtype, vals.dtype)
        out = torch.zeros((num_segments,) + tail, dtype=acc,
                          device=vals.device)
        return out.index_add_(0, seg, vals.to(acc)).to(vals.dtype)
    if name == "GrB_TIMES":
        return _scatter(vals, seg, num_segments, 1, "prod")
    if name in ("GrB_MIN", "GrB_MAX"):
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
    return _segment_scan(vals, seg, num_segments, monoid.op.fn, ident,
                         indices_are_sorted)


def _segment_scan(vals, seg, num_segments, op, ident, indices_are_sorted):
    """Any associative ``op`` by a segmented inclusive scan; the last
    element of each segment holds its total."""
    if not indices_are_sorted:
        order = torch.argsort(seg, stable=True)
        seg, vals = seg[order], vals[order]
    n = vals.shape[0]
    flags = torch.ones(n, dtype=torch.bool, device=vals.device)
    flags[1:] = seg[1:] != seg[:-1]
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
    out = ident.expand((num_segments,) + tuple(vals.shape[1:])).clone()
    out[seg[is_last]] = v[is_last]
    return out


def _segment_reduce_unsigned(vals, seg, num_segments, monoid, ident,
                             indices_are_sorted):
    """segment_reduce on UINT16/32/64 through the carriers: PLUS and TIMES
    wrap there, MIN/MAX/ANY reduce the order keys, the boolean monoids
    read x != 0, any other monoid scans the signed views."""
    dt = vals.dtype
    ty = T.lookup(dt)
    name = monoid.op.name
    c = T.carry(vals)
    if name in ("GrB_PLUS", "GrB_TIMES"):
        return T.uncarry(segment_reduce(c, seg, num_segments, monoid), dt)
    if name in ("GrB_MIN", "GrB_MAX", "GxB_ANY"):
        k = T.order_key(c, dt)
        init = int(T.order_key(T.carry(ident), dt))
        out = _scatter(k, seg, num_segments, init,
                       "amin" if name == "GrB_MIN" else "amax")
        return T.uncarry(T.order_key(out, dt), dt)
    if name in ("GrB_LOR", "GrB_LAND", "GrB_LXOR"):
        r = segment_reduce(T.bits(vals) != 0, seg, num_segments, monoid)
        return T.cast(r, ty)
    op = monoid.op.fn
    out = _segment_scan(
        T.bits(vals), seg, num_segments,
        lambda a, b: T.bits(op(T.unbits(a, dt), T.unbits(b, dt))),
        T.bits(ident), indices_are_sorted)
    return T.unbits(out, dt)


def full_reduce(vals: torch.Tensor, monoid: Monoid, dtype=None
                ) -> torch.Tensor:
    """Reduce a whole array under a monoid (GrB_reduce to scalar); returns
    a 0-d tensor."""
    ty = T.lookup(dtype) if dtype is not None else T.lookup(vals.dtype)
    vals = T.cast(vals.reshape((-1,) + ty.shape), ty)
    ident = monoid.identity_tensor(ty, vals.device)
    if vals.shape[0] == 0:
        return ident
    name = monoid.op.name
    if ty.is_struct:
        seg = torch.zeros(vals.shape[0], dtype=torch.int64,
                          device=vals.device)
        return segment_reduce(vals, seg, 1, monoid)[0]
    if T.wide_unsigned(ty) and name in ("GrB_PLUS", "GrB_TIMES", "GrB_MIN",
                                        "GrB_MAX", "GxB_ANY"):
        seg = torch.zeros(vals.shape[0], dtype=torch.int64,
                          device=vals.device)
        return segment_reduce(vals, seg, 1, monoid)[0]
    if ty.is_bool and name in ("GrB_PLUS", "GrB_MAX"):
        name = "GrB_LOR"
    elif ty.is_bool and name in ("GrB_TIMES", "GrB_MIN"):
        name = "GrB_LAND"
    if name == "GrB_PLUS":
        acc = ACC.get(ty.torch_dtype, ty.torch_dtype)
        return vals.sum(dtype=acc).to(ty.torch_dtype)
    if name == "GrB_TIMES":
        return vals.prod(dtype=ty.torch_dtype)
    if name in ("GrB_MIN", "GrB_MAX"):
        if vals.is_floating_point():
            vals = torch.where(torch.isnan(vals), ident, vals)
        return vals.amin() if name == "GrB_MIN" else vals.amax()
    if name == "GrB_LOR":
        return T.cast((T.bits(vals) != 0).any(), ty)
    if name == "GrB_LAND":
        return T.cast((T.bits(vals) != 0).all(), ty)
    if name == "GrB_LXOR":
        return T.cast((T.bits(vals) != 0).sum() % 2 != 0, ty)
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
    return int(idx.shape[0]), tuple(T.take(a, idx) for a in arrays)


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


# ---------------------------------------------------------------------------
# union merge — the engine behind eWiseAdd / eWiseMult / eWiseUnion, the
# masker and wait()
# ---------------------------------------------------------------------------

def _side_vals(vals, src, present):
    """``vals[src]`` where ``present``, 0 elsewhere: any dtype, trailing
    field dims too, and the bits of what is present as they were (NaN
    payloads and -0.0 survive)."""
    ng = src.shape[0]
    if vals.shape[0] == 0:
        return torch.zeros((ng,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                           device=vals.device)
    v = T.bits(T.take(vals, torch.where(present, src, 0)))
    keep = present.reshape((ng,) + (1,) * (v.dim() - 1))
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    return T.unbits(torch.where(keep, v, zero), vals.dtype)


def union_merge(keysA, valsA, keysB, valsB):
    """Merge two sorted sparse patterns (each side duplicate-free).
    Returns (unique_keys, a_vals, b_vals, a_present, b_present) of length
    nnz(union), absent values 0: one engine for eWiseAdd (union),
    eWiseMult (both present), eWiseUnion (union with fill scalars), the
    masker truth table and wait() (reference: Source/GB_add.h, GB_emult.h,
    GB_masker.c:20-27).

    One stable sort of both key lists puts A's member of a key first, and
    a key has at most two members: presence comes from neighbour
    compares, the group starts are compacted, and each side's payload is
    gathered from the source row the sort's order names."""
    dev = keysA.device
    nA = keysA.shape[0]
    skeys, order = torch.sort(torch.cat([keysA.to(KEY), keysB.to(KEY)]),
                              stable=True)
    n = skeys.shape[0]
    is_new = torch.ones(n, dtype=torch.bool, device=dev)
    is_new[1:] = skeys[1:] != skeys[:-1]
    pair = torch.zeros(n, dtype=torch.bool, device=dev)
    pair[:-1] = ~is_new[1:]
    _, (ukeys, first, second, pair) = compact(
        is_new, skeys, order, torch.roll(order, -1), pair)
    a_in = first < nA
    b_in = ~a_in | pair
    src_b = torch.where(a_in, second, first) - nA
    return (ukeys, _side_vals(valsA, first, a_in),
            _side_vals(valsB, src_b, b_in), a_in, b_in)
