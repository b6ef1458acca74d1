"""GxB_Matrix_resize / GxB_Matrix_reshape (counterpart of
``graphblas_tpu.ops.resize``; reference: Source/GB_resize.c,
GB_reshape.c)."""

from __future__ import annotations

import torch

from ..core import errors as E
from ..core import types as T
from ..core.matrix import BITMAP, FULL, HYPER, INDEX, ROW, SPARSE, Matrix
from ..kernels import segment as K


def resize(A: Matrix, nrows: int, ncols: int) -> Matrix:
    """A with new dimensions (a new matrix); entries outside the new
    bounds are dropped."""
    A.wait()
    if (nrows, ncols) == A.shape:
        return A.dup()
    dev = A.device
    if A.fmt in (BITMAP, FULL):
        v, p = A.to_dense_pair()
        nv = torch.zeros((nrows, ncols), dtype=A.dtype.torch_dtype,
                         device=dev)
        npat = torch.zeros((nrows, ncols), dtype=torch.bool, device=dev)
        rmin, cmin = min(nrows, A.nrows), min(ncols, A.ncols)
        T.bits(nv)[:rmin, :cmin] = T.bits(v)[:rmin, :cmin]
        npat[:rmin, :cmin] = p[:rmin, :cmin]
        return Matrix((nrows, ncols), A.dtype, BITMAP, A.orient, values=nv,
                      bitmap=npat)
    S = A.to_format(SPARSE) if A.fmt == HYPER else A
    rows, cols = S._coords()
    keep = (rows < nrows) & (cols < ncols)
    _, (kr, kc, kv) = K.compact(keep, rows, cols, S._vals_expanded())
    vec, idx, nvec = ((kr, kc, nrows) if S.orient == ROW
                      else (kc, kr, ncols))
    indptr = K.indptr_from_sorted(vec, nvec, INDEX)  # order preserved
    return Matrix((nrows, ncols), A.dtype, SPARSE, S.orient, indptr=indptr,
                  indices=idx.to(INDEX), values=kv)


def reshape(A: Matrix, nrows: int, ncols: int, by_col: bool = True) -> Matrix:
    """Entries reinterpreted by linear index (GxB_Matrix_reshape);
    ``by_col`` (the reference's default) linearizes column-major."""
    if nrows * ncols != A.nrows * A.ncols:
        raise E.DimensionMismatch(
            f"reshape: {A.shape} -> ({nrows},{ncols}) size mismatch")
    S = A.to_format(SPARSE, ROW)
    rows, cols = S._coords()
    if by_col:
        lin = cols.long() * A.nrows + rows.long()
        nr, nc = lin % nrows, lin // nrows
    else:
        lin = rows.long() * A.ncols + cols.long()
        nr, nc = lin // ncols, lin % ncols
    order, skeys = K.sort_coo(nr, nc, ncols)
    svec, sidx = K.key_split(skeys, ncols)
    indptr = K.indptr_from_sorted(svec, nrows, INDEX)
    return Matrix((nrows, ncols), A.dtype, SPARSE, ROW, indptr=indptr,
                  indices=sidx, values=T.take(S._vals_expanded(), order))
