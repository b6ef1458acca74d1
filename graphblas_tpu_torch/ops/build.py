"""GrB_Matrix_build (counterpart of ``graphblas_tpu.ops.build``;
reference: Source/GB_builder.c — copy, sort, detect duplicates, build
indptr, assemble with the dup operator).

Here the pipeline is a tensor program on the target device: a stable
64-bit key sort, grouping, and a segmented reduce under the dup operator.
``apply_pending`` is the pending-tuple finalizer of ``Matrix.wait``
(reference: Source/GB_wait.c).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config as CFG
from ..core import errors as E
from ..core import monoid as M
from ..core import ops as OPS
from ..core import types as T
from ..core.convert import _reclass
from ..core.matrix import (BITMAP, FULL, HYPER, INDEX, ROW, SPARSE, Matrix,
                           _as_tensor)
from ..core.ops import BinaryOp
from ..kernels import segment as K

_DUP_MONOIDS = {
    "GrB_PLUS": M.PLUS, "GrB_TIMES": M.TIMES, "GrB_MIN": M.MIN,
    "GrB_MAX": M.MAX, "GrB_LOR": M.LOR, "GrB_LAND": M.LAND,
    "GrB_LXOR": M.LXOR, "GrB_BOR": M.BOR, "GrB_BAND": M.BAND,
    "GxB_ANY": M.ANY,
}
_NAME_TO_OP = {
    "plus": OPS.PLUS, "times": OPS.TIMES, "min": OPS.MIN, "max": OPS.MAX,
    "first": OPS.FIRST, "second": OPS.SECOND, "lor": OPS.LOR,
    "land": OPS.LAND, "lxor": OPS.LXOR, "any": OPS.ANY,
}


def _resolve_dup(dup) -> BinaryOp:
    if isinstance(dup, BinaryOp):
        return dup
    if isinstance(dup, str):
        return _NAME_TO_OP[dup.lower()]
    raise E.InvalidValue(f"bad dup operator {dup!r}")


def _dedup(sorted_vals, gid, ng: int, dup: BinaryOp, is_first, is_last):
    """Combine duplicate groups under the dup operator (builder step 5)."""
    if dup.name in ("GrB_FIRST", "GrB_SECOND", "GxB_ANY"):
        keep = is_first if dup.name == "GrB_FIRST" else is_last
        out = torch.zeros((ng,) + tuple(sorted_vals.shape[1:]),
                          dtype=sorted_vals.dtype, device=sorted_vals.device)
        T.bits(out)[gid[keep]] = T.bits(sorted_vals)[keep]
        return out
    mon = _DUP_MONOIDS.get(dup.name) or M.monoid(dup, 0)
    return K.segment_reduce(sorted_vals, gid, ng, mon)


def build_matrix(cls, rows, cols, vals, shape, dtype, dup, orient, iso,
                 device=None):
    """``device``: where the result lives; None keeps the device of the
    first tensor among rows/cols/vals, else the default device."""
    orient = orient or CFG.GLOBAL.format_default
    if device is None:
        held = [t for t in (rows, cols, vals) if isinstance(t, torch.Tensor)]
        device = held[0].device if held else CFG.default_device()
    nrows, ncols = int(shape[0]), int(shape[1])
    dup = _resolve_dup(dup)
    rows_t = _as_tensor(rows, dtype=torch.int64, device=device).reshape(-1)
    cols_t = _as_tensor(cols, dtype=torch.int64, device=device).reshape(-1)
    n = cols_t.shape[0]
    if rows_t.shape[0] != n:
        raise E.DimensionMismatch("build: row/col index length mismatch")
    dt = T.lookup(dtype) if dtype is not None else None
    if isinstance(vals, torch.Tensor):
        v = vals.to(device)
    else:
        arr = np.asarray(vals)
        if arr.dtype.name == "bfloat16":    # an ml_dtypes array
            dt, arr = dt or T.BF16, arr.astype(np.float32)
        v = _as_tensor(arr if arr.dtype.kind in "biufc"
                       else arr.astype(np.float64), device=device)
    if dt is None:
        dt = T.lookup(v.dtype)
    fs = dt.shape                       # a struct's field dims
    v = T.cast(v.reshape((-1,) + fs), dt)
    if iso or (v.shape[0] == 1 and n > 1):
        v = v[:1].expand((n,) + fs)
    if v.shape[0] != n:
        raise E.DimensionMismatch("build: index/value length mismatch")
    if n:
        if int(rows_t.min()) < 0 or int(rows_t.max()) >= nrows:
            raise E.IndexOutOfBounds("build: row index out of range")
        if int(cols_t.min()) < 0 or int(cols_t.max()) >= ncols:
            raise E.IndexOutOfBounds("build: col index out of range")

    if orient == ROW:
        vec_ids, idx, nvec, veclen = rows_t, cols_t, nrows, ncols
    else:
        vec_ids, idx, nvec, veclen = cols_t, rows_t, ncols, nrows

    order, skeys = K.sort_coo(vec_ids, idx, veclen)
    gid, ng = K.group_ids(skeys)
    is_first = torch.ones(n, dtype=torch.bool, device=skeys.device)
    is_last = torch.ones(n, dtype=torch.bool, device=skeys.device)
    if n:
        is_first[1:] = skeys[1:] != skeys[:-1]
        is_last[:-1] = skeys[1:] != skeys[:-1]
    ukeys = skeys[is_first]
    uvec, uidx = K.key_split(ukeys, veclen)
    indptr = K.indptr_from_sorted(uvec, nvec, INDEX)
    iso = bool(iso) and n > 0
    out_vals = v[:1].contiguous() if iso else \
        _dedup(T.take(v, order), gid, ng, dup, is_first, is_last)
    out = Matrix((nrows, ncols), dt, SPARSE, orient, iso=iso, indptr=indptr,
                 indices=uidx, values=out_vals)
    return _reclass(out, cls)


# ---------------------------------------------------------------------------
# pending-tuple finalizer (GrB_wait; reference: Source/GB_wait.c)
# ---------------------------------------------------------------------------

def apply_pending(A: Matrix, pend) -> None:
    """Apply queued setElement/removeElement events to A: per (i, j) the
    LAST event wins (setElement overwrites, removeElement deletes), as in
    the reference, where setElement tuples use dup=SECOND and deletions
    become zombies (GB_matrix.h:313-390).

    The events are host numpy until here: the last one per entry is
    picked and sorted on the host, then one copy of the keys (a delete
    flag in the low bit) and one of the values go to A's device.  A is
    rebound to new tensors; none it held is written.  A delete on FULL
    makes it BITMAP; HYPER goes through SPARSE and back."""
    ii, jj, vv, dd = _event_arrays(pend, A.dtype.np_dtype)
    if (ii.min() < 0 or ii.max() >= A.nrows or jj.min() < 0
            or jj.max() >= A.ncols):
        raise E.InvalidIndex("setElement index out of range")
    keep = _last_event_mask(ii, jj, A.ncols)
    ii, jj, vv, dd = ii[keep], jj[keep], vv[keep], dd[keep]
    dev = A.device
    if A.fmt in (BITMAP, FULL):
        flat = torch.from_numpy((ii * A.ncols + jj) << 1 | dd).to(dev)
        pos, gone = flat >> 1, (flat & 1) == 1
        vals = A._vals_expanded().reshape(-1).clone()
        T.bits(vals)[pos] = T.bits(T.from_host(vv, A.dtype, dev))
        bm = (A.bitmap.reshape(-1).clone() if A.fmt == BITMAP else
              torch.ones(A.nrows * A.ncols, dtype=torch.bool, device=dev))
        bm[pos] = ~gone
        A.values, A.iso = vals.reshape(A.shape), False
        if A.fmt == BITMAP or dd.any():
            A.fmt, A.bitmap = BITMAP, bm.reshape(A.shape)
        A._nvals_cache = None
        return
    # sparse/hyper: merge the events with the stored entries
    was_hyper = A.fmt == HYPER
    S = A.to_format(SPARSE) if was_hyper else A
    veclen, nvec = S._veclen(), S._nvec_dim()
    pk = ii * S.ncols + jj if S.orient == ROW else jj * S.nrows + ii
    order = np.argsort(pk, kind="stable")
    pkd = torch.from_numpy(pk[order] << 1 | dd[order]).to(dev)
    pk_d, del_d = pkd >> 1, (pkd & 1) == 1
    vv_d = T.from_host(vv[order], A.dtype, dev)
    rows, cols = S._coords()
    vec_ids, idx = (rows, cols) if S.orient == ROW else (cols, rows)
    ekeys = K.make_key(vec_ids, idx, veclen)
    ukeys, eav, pbv, e_in, p_in = K.union_merge(
        ekeys, S._vals_expanded(), pk_d, vv_d)
    p_del = torch.zeros(ukeys.shape[0], dtype=torch.bool, device=dev)
    p_del[torch.searchsorted(ukeys, pk_d)] = del_d
    newv = T.where(p_in, pbv, eav)
    _, (fk, fv) = K.compact((e_in | p_in) & ~p_del, ukeys, newv)
    uvec, uidx = K.key_split(fk, veclen)
    A.fmt, A.orient, A.h, A.iso = SPARSE, S.orient, None, False
    A.indptr = K.indptr_from_sorted(uvec, nvec, INDEX)
    A.indices, A.values, A._nvals_cache = uidx, fv, None
    if was_hyper:
        A._replace_from(A.to_format(HYPER))


def _event_arrays(pend, dt):
    """(rows, cols, values in ``dt``, delete flags) of the queued events,
    each value cast as ``np.asarray(value).astype(dt)`` casts it.  Where
    every event is one entry and every value one Python type (the
    ``set_element`` case), the values are cast in one array."""
    n = len(pend)
    lens = np.fromiter((len(r) for r, _, _, _ in pend), np.int64, n)
    ii = np.concatenate([np.asarray(r, np.int64) for r, _, _, _ in pend])
    jj = np.concatenate([np.asarray(c, np.int64) for _, c, _, _ in pend])
    gone = np.fromiter((d == "delete" for _, _, _, d in pend), bool, n)
    vals = [v for _, _, v, d in pend if d != "delete"]
    kinds = {type(v) for v in vals}
    if (lens == 1).all() and len(kinds) == 1 and not isinstance(
            vals[0], np.ndarray):
        zero = kinds.pop()(0)
        vv = np.array([zero if d == "delete" else v
                       for _, _, v, d in pend]).astype(dt)
    else:
        vv = np.concatenate([
            np.zeros(k, dt) if d == "delete" else np.broadcast_to(
                np.asarray(v).astype(dt).reshape(-1), (k,))
            for (_, _, v, d), k in zip(pend, lens)])
    return ii, jj, vv, np.repeat(gone, lens)


def _last_event_mask(ii, jj, ncols):
    """Host mask of the last event for each (i, j)."""
    key = ii * np.int64(ncols) + jj
    order = np.argsort(key, kind="stable")
    sk = key[order]
    is_last = np.ones(len(sk), bool)
    is_last[:-1] = sk[1:] != sk[:-1]
    keep = np.zeros(len(sk), bool)
    keep[order[is_last]] = True
    return keep
