"""GrB_Matrix_diag / GxB_Vector_diag (counterpart of
``graphblas_tpu.ops.diag``; reference: Source/GB_Matrix_diag.c,
GxB_Vector_diag)."""

from __future__ import annotations

import torch

from ..core import errors as E
from ..core.matrix import INDEX, ROW, SPARSE, Matrix, Vector
from ..kernels import segment as K


def diag(v, k: int = 0) -> Matrix:
    """The matrix with vector v on its k-th diagonal (GrB_Matrix_diag)."""
    n = v.nrows
    dim = n + abs(k)
    Vs = v.to_format(SPARSE)
    pos, _ = Vs._coords()
    rows = pos.long() + (0 if k >= 0 else -k)
    cols = pos.long() + (k if k >= 0 else 0)
    # already sorted by row (pos ascending)
    indptr = K.indptr_from_sorted(rows, dim, INDEX)
    return Matrix((dim, dim), v.dtype, SPARSE, ROW, indptr=indptr,
                  indices=cols.to(INDEX), values=Vs._vals_expanded())


def vector_diag(A: Matrix, k: int = 0) -> Vector:
    """v = the k-th diagonal of A (GxB_Vector_diag)."""
    m, n = A.shape
    dlen = min(m, n - k) if k >= 0 else min(m + k, n)
    if dlen <= 0:
        raise E.InvalidValue(f"diagonal {k} outside matrix {A.shape}")
    S = A.to_format(SPARSE, ROW)
    rows, cols = S._coords()
    on_diag = cols.long() - rows.long() == k
    cnt, (dr, dv) = K.compact(on_diag, rows, S._vals_expanded())
    pos = dr.long() - (0 if k >= 0 else -k)
    indptr = torch.tensor([0, cnt], dtype=INDEX, device=A.device)
    return Vector((dlen, 1), A.dtype, SPARSE, indptr=indptr,
                  indices=pos.to(INDEX), values=dv)
