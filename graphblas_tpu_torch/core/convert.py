"""Format & conversion engine (counterpart of
``graphblas_tpu.core.convert``; reference: Source/GB_convert_*.c,
GB_conform.c, rules in GB_matrix.h:394-458).

All conversions are device-side tensor programs on the matrix's device;
bitmap->sparse needs one host sync of nnz."""

from __future__ import annotations

import dataclasses

import torch

from . import config as CFG
from . import errors as E
from .matrix import BITMAP, COL, FULL, HYPER, INDEX, SPARSE, Matrix

_FIELDS = tuple(f.name for f in dataclasses.fields(Matrix))


def _clone(a: Matrix, **kw) -> Matrix:
    """Shallow copy of ``a`` (same class) with fields replaced by ``kw``."""
    obj = object.__new__(type(a))
    for f in _FIELDS:
        setattr(obj, f, getattr(a, f))
    obj._nvals_cache = None
    for k, v in kw.items():
        setattr(obj, k, v)
    return obj


def _reclass(a: Matrix, klass) -> Matrix:
    """``a`` as an instance of ``klass`` (Matrix/Vector/Scalar share every
    field)."""
    if type(a) is klass:
        return a
    obj = object.__new__(klass)
    for f in _FIELDS:
        setattr(obj, f, getattr(a, f))
    return obj


def convert(a: Matrix, fmt: str, orient: str) -> Matrix:
    CFG.burble("convert %s/%s -> %s/%s", a.fmt, a.orient, fmt, orient)
    if a.fmt == HYPER:
        a = _hyper_to_sparse(a)
    if a.fmt == fmt and a.orient == orient:
        return a
    if fmt in (BITMAP, FULL):
        # orientation is metadata-only for dense layouts
        if a.fmt == SPARSE:
            return _sparse_to_dense(a, fmt, orient)
        if a.fmt == BITMAP and fmt == FULL:
            return _bitmap_to_full(a, orient)
        if a.fmt == FULL and fmt == BITMAP:
            return _clone(a, fmt=BITMAP, orient=orient,
                          bitmap=torch.ones(a.shape, dtype=torch.bool,
                                            device=a.device))
        return _clone(a, orient=orient)
    # target is sparse or hyper
    if a.fmt in (BITMAP, FULL):
        a = _dense_to_sparse(a, orient)
    elif a.orient != orient:
        a = _sparse_reorient(a, orient)
    if fmt == HYPER:
        a = _sparse_to_hyper(a)
    return a


# -- hyper <-> sparse (reference: GB_convert_hyper_to_sparse.c and back) ----

def _hyper_to_sparse(a: Matrix) -> Matrix:
    nvec = a._nvec_dim()
    counts = torch.zeros(nvec, dtype=torch.int64, device=a.device)
    if a.h.shape[0]:
        counts[a.h.long()] = torch.diff(a.indptr).long()
    full_ptr = torch.zeros(nvec + 1, dtype=torch.int64, device=a.device)
    torch.cumsum(counts, 0, out=full_ptr[1:])
    return _clone(a, fmt=SPARSE, h=None, indptr=full_ptr.to(INDEX))


def _sparse_to_hyper(a: Matrix) -> Matrix:
    counts = torch.diff(a.indptr).long()
    h = torch.nonzero(counts > 0).reshape(-1)
    hptr = torch.zeros(h.shape[0] + 1, dtype=torch.int64, device=a.device)
    torch.cumsum(counts[h], 0, out=hptr[1:])
    return _clone(a, fmt=HYPER, h=h.to(INDEX), indptr=hptr.to(INDEX))


# -- sparse -> dense --------------------------------------------------------

def _sparse_to_dense(a: Matrix, fmt: str, orient: str) -> Matrix:
    vals, present = a.to_dense_pair()
    if fmt == FULL:
        if a.nvals != a.nrows * a.ncols:
            raise E.InvalidValue(
                "cannot convert to full: not all entries present")
        return _clone(a, fmt=FULL, orient=orient, indptr=None, indices=None,
                      values=vals, iso=False, bitmap=None)
    return _clone(a, fmt=BITMAP, orient=orient, indptr=None, indices=None,
                  values=vals, iso=False, bitmap=present)


def _bitmap_to_full(a: Matrix, orient: str) -> Matrix:
    if a.nvals != a.nrows * a.ncols:
        raise E.InvalidValue("cannot convert to full: not all entries present")
    return _clone(a, fmt=FULL, orient=orient, bitmap=None,
                  values=a._vals_expanded(), iso=False)


# -- dense -> sparse ---------------------------------------------------------

def _dense_to_sparse(a: Matrix, orient: str) -> Matrix:
    from ..kernels import segment as K
    present = torch.ones(a.shape, dtype=torch.bool, device=a.device) \
        if a.fmt == FULL else a.bitmap
    vals = a._vals_expanded()
    if orient == COL:
        present_o, vals_o = present.T, vals.T
        nvec, veclen = a.ncols, a.nrows
    else:
        present_o, vals_o = present, vals
        nvec, veclen = a.nrows, a.ncols
    pos = torch.nonzero(present_o.reshape(-1)).reshape(-1)
    kept_vals = vals_o.reshape(-1)[pos]
    vec_ids = (pos // veclen).to(INDEX)
    idx = (pos % veclen).to(INDEX)
    indptr = K.indptr_from_sorted(vec_ids, nvec, INDEX)
    return _clone(a, fmt=SPARSE, orient=orient, bitmap=None, indptr=indptr,
                  indices=idx, values=kept_vals, iso=False)


# -- sparse orientation flip (CSR <-> CSC): a sort-based transpose of the
#    storage, not of the logical matrix ---------------------------------------

def _sparse_reorient(a: Matrix, orient: str) -> Matrix:
    from ..kernels import segment as K
    old_nvec = a._nvec_dim()
    new_nvec = a.ncols if orient == COL else a.nrows
    nnz = int(a.indices.shape[0])
    vecid = K.expand_rowids(a.indptr, nnz, old_nvec)
    # entries are stored by (old vec, idx); a stable sort on idx alone
    # orders them by (new vec = idx, new idx = old vec)
    sidx, order = torch.sort(a.indices, stable=True)
    indptr = K.indptr_from_sorted(sidx, new_nvec, INDEX)
    vals = a.values if a.iso else a._vals_expanded()[order]
    return _clone(a, orient=orient, indptr=indptr,
                  indices=vecid[order].to(INDEX), values=vals)


# -- conform (reference: Source/GB_conform.c — applied after every op) ------

def conform(a: Matrix, like: Matrix | None = None) -> Matrix:
    """Auto format switching after every op (reference: Source/
    GB_conform.c, rules at Source/Shared/GB_matrix.h:394-458), keyed on
    the target's ``sparsity_control`` and the hyper/bitmap switches:

      * all entries present and FULL allowed          -> full
      * density > bitmap_switch and BITMAP allowed    -> bitmap
      * bitmap with density < bitmap_switch/2         -> sparse
      * sparse with nonempty-vector fraction below
        hyper_switch and HYPER allowed                -> hypersparse
      * hyper with fraction >= 2*hyper_switch         -> sparse

    In nonblocking mode the density rules run only when nvals is already
    known (a bitmap's count is a device sync), as in the JAX package."""
    mn = a.nrows * a.ncols
    if mn == 0:
        return a
    src = like if like is not None else a   # controls live on the C target
    ctrl = src.sparsity_control or "auto"
    allowed = ({HYPER, SPARSE, BITMAP, FULL} if ctrl == "auto"
               else {c.strip() for c in ctrl.split("+")})
    bsw = src.bitmap_switch
    if bsw is None:
        bsw = CFG.GLOBAL.bitmap_switch
    hsw = src.hyper_switch
    if hsw is None:
        hsw = CFG.GLOBAL.hyper_switch

    nv = None
    if a.fmt == FULL:
        nv = mn
    elif CFG.GLOBAL.blocking or a._nvals_cache is not None:
        nv = a.nvals

    out = a
    if nv is not None:
        d = nv / mn
        if nv == mn and FULL in allowed and a.fmt != FULL:
            out = convert(a, FULL, a.orient)
        elif a.fmt in (SPARSE, HYPER) and d > bsw and BITMAP in allowed:
            out = convert(a, BITMAP, a.orient)
        elif a.fmt == BITMAP and d <= bsw / 2 and SPARSE in allowed:
            out = convert(a, SPARSE, a.orient)
    if out.fmt == SPARSE and HYPER in allowed and nv is not None:
        nvec = out._nvec_dim()
        # sufficient, sync-free: nonempty <= nvals, so nvals < h*nvec
        # implies the nonempty fraction is below the switch
        if nvec and nv < hsw * nvec:
            out = convert(out, HYPER, out.orient)
    elif out.fmt == HYPER and SPARSE in allowed:
        nvec = out._nvec_dim()
        if nvec and out.h.shape[0] >= 2 * hsw * nvec:
            out = convert(out, SPARSE, out.orient)
    if out is not a:
        CFG.burble("conform: %s -> %s", a.fmt, out.fmt)
    return out
