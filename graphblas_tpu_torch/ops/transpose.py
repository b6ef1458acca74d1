"""Transpose (counterpart of ``graphblas_tpu.ops.transpose``; reference:
Source/GB_transpose.c).

A logical transpose of a sparse matrix is O(1): swap the shape and flip
the orientation tag; the CSR arrays of A are exactly the CSC arrays of A'.
Reorientation happens lazily in to_orient() when a kernel needs it.
"""

from __future__ import annotations

from ..core.convert import _clone
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import BITMAP, COL, HYPER, ROW, SPARSE, Matrix
from .masker import writeback


def logical_transpose(a: Matrix) -> Matrix:
    """A' in O(1) for sparse/hyper; one tensor transpose for bitmap/full."""
    new_shape = (a.ncols, a.nrows)
    if a.fmt in (SPARSE, HYPER):
        flip = ROW if a.orient == COL else COL
        return _clone(a, orient=flip, shape=new_shape)
    vals = a.values if a.iso else a.values.transpose(0, 1)
    bm = a.bitmap.T if a.fmt == BITMAP else None
    return _clone(a, values=vals, bitmap=bm, shape=new_shape)


def maybe_transpose(a: Matrix, tran: bool) -> Matrix:
    return logical_transpose(a) if tran else a


def transpose(A: Matrix, *, C=None, mask=None, accum=None,
              desc: Descriptor = NULL, out_dtype=None):
    """GrB_transpose: C<M> = accum(C, A').  Per the spec, desc.transpose0
    cancels the transpose (C<M> = accum(C, A))."""
    Tm = A.dup() if desc.transpose0 else logical_transpose(A)
    return writeback(C, mask, accum, Tm, desc, out_dtype)
