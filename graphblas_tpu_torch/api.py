"""Public operation API (counterpart of ``graphblas_tpu.api``, the subset
the SpMV and SpGEMM paths need).  Every op returns the result; passing ``C=``
updates C in place through accum/mask and returns it, like the C API."""

from __future__ import annotations

from .core.descriptor import NULL
from .core.matrix import Matrix
from .ops import apply as _apply_mod
from .ops import mxm as _mxm
from .ops import reduce as _reduce
from .ops import select as _select_mod
from .ops import transpose as _transpose_mod


def _finish(C, out):
    from .core.convert import conform
    if isinstance(out, Matrix):
        # sparsity control is a property of the C target
        out = conform(out, like=C)
    if C is not None:
        C._replace_from(out)
        return C
    return out


def apply(A, op, *, bind=None, thunk=None, C=None, mask=None, accum=None,
          desc=NULL, out_dtype=None):
    return _finish(C, _apply_mod.apply(A, op, bind=bind, thunk=thunk, C=C,
                                       mask=mask, accum=accum, desc=desc,
                                       out_dtype=out_dtype))


def select(A, op, thunk=0, *, C=None, mask=None, accum=None, desc=NULL,
           out_dtype=None):
    """GrB_select: entries of A where ``op(a_ij, i, j, thunk)`` holds."""
    return _finish(C, _select_mod.select(A, op, thunk, C=C, mask=mask,
                                         accum=accum, desc=desc,
                                         out_dtype=out_dtype))


def reduce(A, mon, *, C=None, mask=None, accum=None, desc=NULL,
           out_dtype=None):
    """Matrix -> Vector rowwise reduce (GrB_Matrix_reduce_Monoid)."""
    return _finish(C, _reduce.reduce_to_vector(A, mon, C=C, mask=mask,
                                               accum=accum, desc=desc,
                                               out_dtype=out_dtype))


def reduce_scalar(A, mon, *, accum=None, init=None, out_dtype=None):
    """Matrix/Vector -> scalar reduce (GrB_Matrix_reduce_TYPE)."""
    return _reduce.reduce_to_scalar(A, mon, accum=accum, init=init,
                                    out_dtype=out_dtype)


def transpose(A, *, C=None, mask=None, accum=None, desc=NULL,
              out_dtype=None):
    return _finish(C, _transpose_mod.transpose(A, C=C, mask=mask,
                                               accum=accum, desc=desc,
                                               out_dtype=out_dtype))


def mxm(A, B, semiring, *, C=None, mask=None, accum=None, desc=NULL,
        out_dtype=None):
    return _finish(C, _mxm.mxm(A, B, semiring, C=C, mask=mask, accum=accum,
                               desc=desc, out_dtype=out_dtype))


def mxv(A, u, semiring, *, C=None, mask=None, accum=None, desc=NULL,
        out_dtype=None):
    return _finish(C, _mxm.mxv(A, u, semiring, C=C, mask=mask, accum=accum,
                               desc=desc, out_dtype=out_dtype))


def vxm(u, A, semiring, *, C=None, mask=None, accum=None, desc=NULL,
        out_dtype=None):
    return _finish(C, _mxm.vxm(u, A, semiring, C=C, mask=mask, accum=accum,
                               desc=desc, out_dtype=out_dtype))


def vxm_chain(u, A, semiring, steps):
    """K-step vxm pipeline (see ops/mxm.vxm_chain)."""
    return _mxm.vxm_chain(u, A, semiring, steps)


def mxm_reduce_scalar(A, B, semiring, *, mask=None, desc=NULL):
    """Fused reduce(C<M> = A (+).(x) B) under PLUS (see
    ops/mxm.mxm_reduce_scalar): an int64 device scalar, or None when the
    fused path does not apply."""
    return _mxm.mxm_reduce_scalar(A, B, semiring, mask=mask, desc=desc)
