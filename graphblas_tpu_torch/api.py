"""Public operation API (counterpart of ``graphblas_tpu.api``, with
serialize / deserialize beside it).  Every op returns the
result; passing ``C=`` updates C in place through accum/mask and returns
it, like the C API.  Every op first applies the events still queued on
its operands (``Matrix.wait``)."""

from __future__ import annotations

from .core.descriptor import NULL
from .core.matrix import Matrix
from .ops import apply as _apply_mod
from .ops import ewise as _ewise
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


def _wait(*objs) -> None:
    for x in objs:
        if isinstance(x, Matrix):
            x.wait()


def ewise_add(A, B, op, *, C=None, mask=None, accum=None, desc=NULL,
              out_dtype=None):
    _wait(A, B, C, mask)
    return _finish(C, _ewise.ewise_add(A, B, op, C=C, mask=mask, accum=accum,
                                       desc=desc, out_dtype=out_dtype))


def ewise_mult(A, B, op, *, C=None, mask=None, accum=None, desc=NULL,
               out_dtype=None):
    _wait(A, B, C, mask)
    return _finish(C, _ewise.ewise_mult(A, B, op, C=C, mask=mask,
                                        accum=accum, desc=desc,
                                        out_dtype=out_dtype))


def ewise_union(A, alpha, B, beta, op, *, C=None, mask=None, accum=None,
                desc=NULL, out_dtype=None):
    _wait(A, B, C, mask)
    return _finish(C, _ewise.ewise_union(A, alpha, B, beta, op, C=C,
                                         mask=mask, accum=accum, desc=desc,
                                         out_dtype=out_dtype))


def apply(A, op, *, bind=None, thunk=None, C=None, mask=None, accum=None,
          desc=NULL, out_dtype=None):
    _wait(A, C, mask)
    return _finish(C, _apply_mod.apply(A, op, bind=bind, thunk=thunk, C=C,
                                       mask=mask, accum=accum, desc=desc,
                                       out_dtype=out_dtype))


def select(A, op, thunk=0, *, C=None, mask=None, accum=None, desc=NULL,
           out_dtype=None):
    """GrB_select: entries of A where ``op(a_ij, i, j, thunk)`` holds."""
    _wait(A, C, mask)
    return _finish(C, _select_mod.select(A, op, thunk, C=C, mask=mask,
                                         accum=accum, desc=desc,
                                         out_dtype=out_dtype))


def reduce(A, mon, *, C=None, mask=None, accum=None, desc=NULL,
           out_dtype=None):
    """Matrix -> Vector rowwise reduce (GrB_Matrix_reduce_Monoid)."""
    _wait(A, C, mask)
    return _finish(C, _reduce.reduce_to_vector(A, mon, C=C, mask=mask,
                                               accum=accum, desc=desc,
                                               out_dtype=out_dtype))


def reduce_scalar(A, mon, *, accum=None, init=None, out_dtype=None):
    """Matrix/Vector -> scalar reduce (GrB_Matrix_reduce_TYPE)."""
    _wait(A)
    return _reduce.reduce_to_scalar(A, mon, accum=accum, init=init,
                                    out_dtype=out_dtype)


def transpose(A, *, C=None, mask=None, accum=None, desc=NULL,
              out_dtype=None):
    _wait(A, C, mask)
    return _finish(C, _transpose_mod.transpose(A, C=C, mask=mask,
                                               accum=accum, desc=desc,
                                               out_dtype=out_dtype))


def mxm(A, B, semiring, *, C=None, mask=None, accum=None, desc=NULL,
        out_dtype=None):
    _wait(A, B, C, mask)
    return _finish(C, _mxm.mxm(A, B, semiring, C=C, mask=mask, accum=accum,
                               desc=desc, out_dtype=out_dtype))


def mxv(A, u, semiring, *, C=None, mask=None, accum=None, desc=NULL,
        out_dtype=None):
    _wait(A, u, C, mask)
    return _finish(C, _mxm.mxv(A, u, semiring, C=C, mask=mask, accum=accum,
                               desc=desc, out_dtype=out_dtype))


def vxm(u, A, semiring, *, C=None, mask=None, accum=None, desc=NULL,
        out_dtype=None):
    _wait(u, A, C, mask)
    return _finish(C, _mxm.vxm(u, A, semiring, C=C, mask=mask, accum=accum,
                               desc=desc, out_dtype=out_dtype))


def vxm_chain(u, A, semiring, steps):
    """K-step vxm pipeline (see ops/mxm.vxm_chain)."""
    _wait(u, A)
    return _mxm.vxm_chain(u, A, semiring, steps)


def mxm_reduce_scalar(A, B, semiring, *, mask=None, desc=NULL):
    """Fused reduce(C<M> = A (+).(x) B) under PLUS (see
    ops/mxm.mxm_reduce_scalar): an int64 device scalar, or None when the
    fused path does not apply."""
    _wait(A, B, mask)
    return _mxm.mxm_reduce_scalar(A, B, semiring, mask=mask, desc=desc)


def extract(A, I=None, J=None, *, C=None, mask=None, accum=None, desc=NULL,
            out_dtype=None):
    """C<M> = accum(C, A(I,J)) (GrB_extract); I/J: None (all), a slice, a
    range or an index array."""
    from .ops import extract as _ex
    _wait(A, C, mask)
    return _finish(C, _ex.extract(A, I, J, C=C, mask=mask, accum=accum,
                                  desc=desc, out_dtype=out_dtype))


def assign(C, A, I=None, J=None, *, mask=None, accum=None, desc=NULL):
    """C<M>(I,J) = accum(C(I,J), A), the mask over all of C
    (GrB_assign); A a Matrix or a scalar."""
    from .ops import assign as _as
    _wait(C, A, mask)
    return _finish(C, _as.assign(C, A, I, J, mask=mask, accum=accum,
                                 desc=desc, subassign=False))


def subassign(C, A, I=None, J=None, *, mask=None, accum=None, desc=NULL):
    """C(I,J)<M> = accum(C(I,J), A), the mask over the region
    (GxB_subassign)."""
    from .ops import assign as _as
    _wait(C, A, mask)
    return _finish(C, _as.assign(C, A, I, J, mask=mask, accum=accum,
                                 desc=desc, subassign=True))


def kronecker(A, B, op, *, C=None, mask=None, accum=None, desc=NULL,
              out_dtype=None):
    from .ops import kron as _kron
    _wait(A, B, C, mask)
    return _finish(C, _kron.kron(A, B, op, C=C, mask=mask, accum=accum,
                                 desc=desc, out_dtype=out_dtype))


def concat(tiles, *, C=None):
    from .ops import concat as _cc
    _wait(C, *(t for row in tiles for t in row))
    return _finish(C, _cc.concat(tiles))


def split(A, row_sizes, col_sizes):
    from .ops import concat as _cc
    _wait(A)
    return _cc.split(A, row_sizes, col_sizes)


def diag(v, k=0):
    """The matrix with v on its k-th diagonal (GrB_Matrix_diag)."""
    from .ops import diag as _dg
    _wait(v)
    return _dg.diag(v, k)


def sort(A, op=None, *, ascending=True, desc=NULL):
    """(C, P): each row's values sorted, and their columns
    (GxB_Matrix_sort)."""
    from .ops import sort as _sort
    _wait(A)
    return _sort.sort(A, op, ascending=ascending, desc=desc)


def vector_diag(A, k=0):
    """v = the k-th diagonal of A (GxB_Vector_diag)."""
    from .ops import diag as _dg
    _wait(A)
    return _dg.vector_diag(A, k)


def serialize(A, compression=None, level=None, desc=None):
    """Matrix -> blob (GxB_Matrix_serialize); see ops/serialize.py."""
    from .ops import serialize as _ser
    return _ser.serialize(A, compression, level, desc)


def deserialize(blob, device=None):
    """Blob -> Matrix (GxB_Matrix_deserialize) on ``device``."""
    from .ops import serialize as _ser
    return _ser.deserialize(blob, device)
