"""GrB_select: keep entries passing an IndexUnaryOp predicate (counterpart
of ``graphblas_tpu.ops.select``; reference: Source/GB_select.h — phase1/
phase2 + bitmap paths collapse to one predicated compaction)."""

from __future__ import annotations

import torch

from ..core import config as CFG
from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import BITMAP, FULL, HYPER, INDEX, SPARSE, Matrix
from ..core.ops import IndexUnaryOp
from ..kernels import segment as K
from .masker import writeback
from .transpose import maybe_transpose


def select(A: Matrix, op: IndexUnaryOp, thunk=0, *, C=None, mask=None,
           accum=None, desc: Descriptor = NULL, out_dtype=None):
    A = maybe_transpose(A, desc.transpose0)
    # a value thunk against an unsigned A takes A's type (torch has no
    # promotion rule for the unsigned dtypes)
    thunk = T.scalar(thunk, A.dtype, A.device) if op.value_only and \
        T.wide_unsigned(A.dtype) and not isinstance(thunk, torch.Tensor) \
        else torch.as_tensor(thunk, device=A.device)
    CFG.burble("select %s (%s)", op.name, A.fmt)
    if A.fmt in (BITMAP, FULL):
        v, p = A.to_dense_pair()
        ii = torch.arange(A.nrows, device=A.device)[:, None].expand(A.shape)
        jj = torch.arange(A.ncols, device=A.device)[None, :].expand(A.shape)
        keep = (op.fn(v, ii, jj, thunk) != 0) & p
        zv = T.where(keep, v, torch.zeros((), dtype=v.dtype,
                                          device=A.device))
        Tm = Matrix(A.shape, A.dtype, BITMAP, A.orient, values=zv,
                    bitmap=keep)
    else:
        S = A.to_format(SPARSE) if A.fmt == HYPER else A
        nvec = S._nvec_dim()
        nnz = int(S.indices.shape[0])
        vecid = K.expand_rowids(S.indptr, nnz, nvec).long()
        idx = S.indices.long()
        rows, cols = (vecid, idx) if S.orient == "row" else (idx, vecid)
        keep = op.fn(S._vals_expanded(), rows, cols, thunk) != 0
        counts = K.histogram_sorted(vecid, nvec, weights=keep)
        indptr = torch.zeros(nvec + 1, dtype=torch.int64, device=A.device)
        torch.cumsum(counts, 0, out=indptr[1:])
        vals = T.take(S._vals_expanded(), keep)
        Tm = Matrix(A.shape, A.dtype, SPARSE, S.orient,
                    indptr=indptr.to(INDEX), indices=S.indices[keep],
                    values=vals.contiguous())
    klass = type(A) if C is None else None
    return writeback(C, mask, accum, Tm, desc, out_dtype, out_class=klass)
