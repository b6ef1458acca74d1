"""GrB_Matrix_build (counterpart of ``graphblas_tpu.ops.build``;
reference: Source/GB_builder.c — copy, sort, detect duplicates, build
indptr, assemble with the dup operator).

Here the pipeline is a tensor program on the target device: a stable
64-bit key sort, grouping, and a segmented reduce under the dup operator.
The pending-tuple finalizer (``apply_pending``) comes with non-blocking
mode in a later part of the port.
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
from ..core.matrix import INDEX, ROW, SPARSE, Matrix, _as_tensor
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
        out = torch.zeros(ng, dtype=sorted_vals.dtype,
                          device=sorted_vals.device)
        out[gid[keep]] = sorted_vals[keep]
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
        v = _as_tensor(arr if arr.dtype.kind in "biufc"
                       else arr.astype(np.float64), device=device)
    v = v.reshape(-1)
    if dt is None:
        dt = T.lookup(v.dtype)
    v = T.cast(v, dt)
    if iso:
        scal = v[:1]
        v = scal.expand(n)
    elif v.shape[0] == 1 and n > 1:
        v = v.expand(n)
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
        _dedup(v[order], gid, ng, dup, is_first, is_last)
    out = Matrix((nrows, ncols), dt, SPARSE, orient, iso=iso, indptr=indptr,
                 indices=uidx, values=out_vals)
    return _reclass(out, cls)
