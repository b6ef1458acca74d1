"""GrB_assign / GxB_subassign: C(I,J)<M> = accum(C(I,J), A) (counterpart
of ``graphblas_tpu.ops.assign``; reference: Source/GB_assign.c,
GB_subassigner_method.c — ~30 numbered methods keyed on {scalar?,
accum?, mask?, comp?, replace?, C format, aliasing}).

A handful of orthogonal paths:

  * subassign  = extract the region -> writeback on it -> splice back;
  * assign     = build T (C with the region replaced, unmasked) ->
                 writeback under the global mask -> restore C outside
                 the region unless replace;
  * C<M> = x over ALL with a sparse mask and sparse C = one union merge
    of C with the mask's pattern (the reference's Method 05d/05e);
  * BITMAP/FULL C = dense scatter (``index_put_`` on the signed views).

The mask's scope (assign: all of C; subassign: C(I,J)) is the
reference's GrB_assign/GxB_subassign distinction.  A scalar is cast to
C's type as numpy's ``astype`` casts it (as the JAX package does).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import (BITMAP, FULL, HYPER, INDEX, ROW, SPARSE, Matrix,
                           Scalar)
from ..core.types import cast
from ..kernels import segment as K
from .extract import extract_pattern, normalize_index
from .masker import _keys_of, writeback
from .transpose import maybe_transpose


def _is_scalar(A) -> bool:
    return np.isscalar(A) or isinstance(A, Scalar) or (
        not isinstance(A, Matrix) and getattr(A, "ndim", None) == 0)


def _scalar_tensor(A, C: Matrix) -> torch.Tensor:
    """The scalar as a 0-d tensor of C's type on C's device."""
    if isinstance(A, torch.Tensor):
        A = A.item()
    return T.from_host(np.asarray(A).reshape(1), C.dtype,
                       C.device).reshape(())


def assign(C: Matrix, A, I=None, J=None, *, mask=None, accum=None,
           desc: Descriptor = NULL, subassign=False) -> Matrix:
    Iv = normalize_index(I, C.nrows)
    Jv = normalize_index(J, C.ncols)
    is_scalar = _is_scalar(A)
    if isinstance(A, Scalar):
        A = A.value()
    full_region = len(Iv) == C.nrows and len(Jv) == C.ncols and \
        np.array_equal(Iv, np.arange(C.nrows)) and \
        np.array_equal(Jv, np.arange(C.ncols))

    # C<M> = scalar over ALL with a sparse mask and sparse C (reference
    # Method 05d/05e)
    if (is_scalar and full_region and mask is not None
            and mask.fmt in (SPARSE, HYPER) and C.fmt in (SPARSE, HYPER)
            and not desc.mask_complement and accum is None
            and not desc.replace):
        CFG.burble("assign: sparse-mask scalar fast path")
        return _scalar_mask_merge(C, A, mask, desc)

    if not is_scalar:
        A = maybe_transpose(A, desc.transpose0)
        if A.shape != (len(Iv), len(Jv)):
            hint = " (transposed?)" if A.shape == (len(Jv), len(Iv)) else ""
            raise E.DimensionMismatch(
                f"assign: A {A.shape} vs region {(len(Iv), len(Jv))}{hint}")

    if subassign:
        return _subassign(C, A, Iv, Jv, is_scalar, mask, accum, desc)
    return _assign_full_mask(C, A, Iv, Jv, is_scalar, mask, accum, desc)


def _region_matrix(C, A, Iv, Jv, is_scalar):
    """A as a (len(I), len(J)) matrix; a scalar becomes iso FULL."""
    if not is_scalar:
        return A
    return Matrix((len(Iv), len(Jv)), C.dtype, FULL, C.orient, iso=True,
                  values=_scalar_tensor(A, C).reshape(1))


def _subassign(C, A, Iv, Jv, is_scalar, mask, accum, desc):
    CFG.burble("subassign: extract-writeback-splice")
    Am = _region_matrix(C, A, Iv, Jv, is_scalar)
    S = extract_pattern(C, Iv, Jv)
    d2 = desc.with_(transpose0=False, transpose1=False)
    Z = writeback(S, mask, accum, Am, d2, out_dtype=C.dtype)
    return _splice(C, Z, Iv, Jv)


def _assign_full_mask(C, A, Iv, Jv, is_scalar, mask, accum, desc):
    CFG.burble("assign: global-mask path")
    Am = _region_matrix(C, A, Iv, Jv, is_scalar)
    S = extract_pattern(C, Iv, Jv)
    Z = writeback(S, None, accum, Am, NULL, out_dtype=C.dtype)
    Tfull = _splice(C, Z, Iv, Jv)
    d2 = desc.with_(transpose0=False, transpose1=False)
    R = writeback(C, mask, None, Tfull, d2, out_dtype=C.dtype)
    if desc.replace:
        return R
    # outside the region, entries revert to C (assign deletes nothing
    # outside C(I,J) unless replace) — reference: GB_assign.c
    return _restore_outside(R, C, Iv, Jv)


def _in_region(C: Matrix, Iv, Jv):
    """(bool per row of C in I, bool per column in J)."""
    in_i = torch.zeros(C.nrows, dtype=torch.bool, device=C.device)
    in_i[torch.from_numpy(Iv).to(C.device)] = True
    in_j = torch.zeros(C.ncols, dtype=torch.bool, device=C.device)
    in_j[torch.from_numpy(Jv).to(C.device)] = True
    return in_i, in_j


def _cat(*ts):
    """torch.cat of value tensors of one dtype (through the signed views:
    the card has no cat for the wide unsigned dtypes)."""
    return T.unbits(torch.cat([T.bits(t) for t in ts]), ts[0].dtype)


def _sorted_matrix(shape, dt, orient, rows, cols, vals) -> Matrix:
    """A SPARSE matrix from duplicate-free COO entries in any order."""
    vec, idx, nvec, veclen = ((rows, cols, shape[0], shape[1])
                              if orient == ROW else
                              (cols, rows, shape[1], shape[0]))
    order, skeys = K.sort_coo(vec, idx, veclen)
    svec, sidx = K.key_split(skeys, veclen)
    indptr = K.indptr_from_sorted(svec, nvec, INDEX)
    return Matrix(shape, dt, SPARSE, orient, indptr=indptr, indices=sidx,
                  values=T.take(vals, order))


def _splice(C, Z, Iv, Jv):
    """C with the region (Iv, Jv) replaced by Z (region-shaped)."""
    dev = C.device
    if C.fmt in (BITMAP, FULL):
        cv, cp = C.to_dense_pair()
        zv, zp = Z.to_dense_pair()
        cv = cv.clone(memory_format=torch.contiguous_format)
        cp = cp.clone(memory_format=torch.contiguous_format)
        ii = torch.from_numpy(Iv).to(dev)[:, None]
        jj = torch.from_numpy(Jv).to(dev)[None, :]
        T.bits(cv).index_put_((ii, jj), T.bits(cast(zv, C.dtype)))
        cp.index_put_((ii, jj), zp)
        return Matrix(C.shape, C.dtype, BITMAP, C.orient, values=cv,
                      bitmap=cp)
    # sparse: drop C's entries inside the region, add Z's at their global
    # coordinates
    S = C.to_format(SPARSE) if C.fmt == HYPER else C
    rows, cols = S._coords()
    in_i, in_j = _in_region(C, Iv, Jv)
    outside = ~(in_i[rows.long()] & in_j[cols.long()])
    _, (orow, ocol, oval) = K.compact(outside, rows, cols,
                                      cast(S._vals_expanded(), C.dtype))
    Zs = Z.to_format(SPARSE) if Z.fmt in (BITMAP, FULL, HYPER) else Z
    zr, zc = Zs._coords()
    gi = torch.from_numpy(Iv).to(dev)[zr.long()]
    gj = torch.from_numpy(Jv).to(dev)[zc.long()]
    zv = cast(Zs._vals_expanded(), C.dtype)
    return _sorted_matrix(C.shape, C.dtype, S.orient,
                          torch.cat([orow.long(), gi]),
                          torch.cat([ocol.long(), gj]), _cat(oval, zv))


def _restore_outside(R, C, Iv, Jv):
    """R with the entries outside the region reverted to C (pattern and
    values)."""
    in_i, in_j = _in_region(C, Iv, Jv)
    if R.fmt in (BITMAP, FULL) or C.fmt in (BITMAP, FULL):
        rv, rp = R.to_dense_pair()
        cv, cp = C.to_dense_pair()
        region = in_i[:, None] & in_j[None, :]
        nv = T.where(region, rv, cast(cv, R.dtype))
        np_ = torch.where(region, rp, cp)
        nv = T.where(np_, nv, torch.zeros((), dtype=R.dtype.torch_dtype,
                                          device=C.device))
        return Matrix(C.shape, R.dtype, BITMAP, C.orient, values=nv,
                      bitmap=np_)
    # both sparse: R's entries inside the region, C's outside it
    Rs = R.to_format(SPARSE, C.orient)
    rr, rc = Rs._coords()
    inside = in_i[rr.long()] & in_j[rc.long()]
    _, (ir, ic, iv) = K.compact(inside, rr, rc, Rs._vals_expanded())
    S = C.to_format(SPARSE) if C.fmt == HYPER else C
    crows, ccols = S._coords()
    outside = ~(in_i[crows.long()] & in_j[ccols.long()])
    _, (orow, ocol, oval) = K.compact(outside, crows, ccols,
                                      cast(S._vals_expanded(), R.dtype))
    return _sorted_matrix(C.shape, R.dtype, S.orient,
                          torch.cat([orow.long(), ir.long()]),
                          torch.cat([ocol.long(), ic.long()]),
                          _cat(oval, iv))


def _scalar_mask_merge(C, scalar, mask, desc):
    """C<M> = x with M sparse: a union merge of C with M's pattern
    carrying the scalar (reference: GB_subassign 05d/05e).  Unless the
    mask is structural, M's explicit zeros (false) are dropped first."""
    orient = C.orient
    Cs = C.to_format(SPARSE) if C.fmt == HYPER else C
    Ms = mask.to_format(SPARSE, orient)
    ck, cvals = _keys_of(Cs)
    mk, mvals = _keys_of(Ms)
    if not desc.mask_structure:
        _, (mk,) = K.compact(T.bits(mvals) != 0, mk)
    mfill = _scalar_tensor(scalar, C).expand(mk.shape[0])
    ukeys, ucv, umv, c_in, m_in = K.union_merge(ck, cvals, mk, mfill)
    vals = T.where(m_in, umv, ucv)
    uvec, uidx = K.key_split(ukeys, C._veclen())
    indptr = K.indptr_from_sorted(uvec, C._nvec_dim(), INDEX)
    return Matrix(C.shape, C.dtype, SPARSE, orient, indptr=indptr,
                  indices=uidx, values=vals)
