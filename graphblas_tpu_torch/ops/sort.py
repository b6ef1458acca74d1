"""GxB_Matrix_sort: sort the values within each row (or column, through
the transpose descriptor) — counterpart of ``graphblas_tpu.ops.sort``;
reference: Source/GB_sort.c.

The values are ordered exactly: a stable sort by value key (ascending,
or descending for GT), then a stable sort by row, so that equal values
keep their column order (the tie rule: column ascending).  The value
keys are the values themselves for signed and float types, the
order-flipped carrier bits for the unsigned ones (``types.order_key``),
(real, imaginary) for complex.  The JAX package sorts descending by
negating the values, which wraps INT*_MIN onto itself and orders the
unsigned types through float64 (ties above 2^53); its ties are
unspecified.

A comparator other than LT/GT runs the host tier: a per-row
``functools.cmp_to_key`` sort, refused above ``USER_CMP_MAX_NNZ``
entries.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import INDEX, ROW, SPARSE, Matrix
from ..core.ops import BinaryOp
from .transpose import maybe_transpose

USER_CMP_MAX_NNZ = 1 << 16   # the host comparator tier's size guard


def sort(A: Matrix, op: BinaryOp | None = None, *, ascending=True,
         desc: Descriptor = NULL):
    """Returns (C, P): C(i,k) = the k-th sorted value of row i (entries
    packed left), P(i,k) = its original column index (INT64).  ``op`` may
    be a comparator BinaryOp: LT (ascending, the default), GT
    (descending) or any other strict weak order (the host tier)."""
    user_cmp = None
    if op is not None:
        if op.name == "GrB_GT":
            ascending = False
        elif op.name == "GrB_LT":
            ascending = True
        else:
            user_cmp = op
    A = maybe_transpose(A, desc.transpose0)
    S = A.to_format(SPARSE, ROW)
    rows, cols = S._coords()
    vals = S._vals_expanded()
    nnz = int(vals.shape[0])
    if nnz == 0:
        return (Matrix(A.shape, A.dtype, SPARSE, ROW, device=A.device),
                Matrix(A.shape, T.INT64, SPARSE, ROW, device=A.device))
    if user_cmp is not None:
        order = _user_cmp_order(S, vals, nnz, user_cmp)
    else:
        CFG.burble("sort: %d entries %s", nnz,
                   "asc" if ascending else "desc")
        order = torch.arange(nnz, dtype=torch.int64, device=A.device)
        # least significant key first; each pass is stable
        for key in reversed(_value_keys(vals)):
            _, o = torch.sort(key[order], stable=True,
                              descending=not ascending)
            order = order[o]
        _, o = torch.sort(rows[order], stable=True)
        order = order[o]
    # rank within the row = position - row start
    srows = rows[order].long()
    rank = torch.arange(nnz, dtype=torch.int64, device=A.device) - \
        S.indptr.long()[srows]
    C = Matrix(A.shape, A.dtype, SPARSE, ROW, indptr=S.indptr,
               indices=rank.to(INDEX), values=T.take(vals, order))
    P = Matrix(A.shape, T.INT64, SPARSE, ROW, indptr=S.indptr,
               indices=rank.to(INDEX), values=cols[order].long())
    return C, P


def _value_keys(vals: torch.Tensor):
    """Sort keys that order like the values, most significant first."""
    if vals.is_complex():
        return [vals.real, vals.imag]
    if vals.dtype == torch.bool:
        return [vals.to(torch.int8)]
    if T.wide_unsigned(vals.dtype):
        return [T.order_key(T.carry(vals), vals.dtype)]
    return [vals]


def _user_cmp_order(S, vals, nnz, op):
    """Host tier for GxB_Matrix_sort with a user comparator: per row,
    ``sorted`` under ``functools.cmp_to_key`` (a stable sort, so ties
    keep their column order)."""
    if nnz > USER_CMP_MAX_NNZ:
        raise E.InvalidValue(
            f"sort: a user comparator ({op.name}) sorts on the host, one "
            f"Python call per compare; {nnz} entries exceed its limit of "
            f"{USER_CMP_MAX_NNZ} (use LT or GT)")
    CFG.burble("sort: %d entries user comparator (host tier)", nnz)
    vh = vals.cpu()
    fn = op.fn

    def cmp(a, b):
        if bool(fn(vh[a], vh[b])):
            return -1
        if bool(fn(vh[b], vh[a])):
            return 1
        return 0

    order = np.empty(nnz, np.int64)
    ip = S.indptr.cpu().numpy()
    key = functools.cmp_to_key(cmp)
    for r in range(S.nrows):
        lo, hi = int(ip[r]), int(ip[r + 1])
        order[lo:hi] = sorted(range(lo, hi), key=key)
    return torch.from_numpy(order).to(S.device)
