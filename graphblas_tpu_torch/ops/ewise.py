"""Element-wise operations: eWiseAdd (union), eWiseMult (intersection),
eWiseUnion (union with fill scalars) — counterpart of
``graphblas_tpu.ops.ewise`` (reference: Source/GB_add.h, the 3-phase
union merge; Source/GB_emult.h, methods 01-10 by sparsity; Source/
GB_ewise.c, the dense fast paths GB_ewise_fulla/fulln).

Two paths:

  * dense path (any operand bitmap/full): one ``where`` expression over
    the dense (values, present) pairs.
  * sparse path: one ``segment.union_merge`` (a stable sort of both
    key lists and a gather of each side's payload) in place of all ten
    emult methods and the add phases.

Mask, accum, replace and the transpose descriptors go through
``masker.writeback``.
"""

from __future__ import annotations

import torch

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..core.descriptor import NULL
from ..core.matrix import (BITMAP, FULL, HYPER, INDEX, ROW, SPARSE, Matrix,
                           Vector)
from ..core.ops import BinaryOp
from ..core.types import cast
from ..kernels import segment as K
from .masker import _keys_of, writeback
from .transpose import maybe_transpose

_POS = {"firsti": (0, 0), "firsti1": (0, 1), "firstj": (1, 0),
        "firstj1": (1, 1), "secondi": (0, 0), "secondi1": (0, 1),
        "secondj": (1, 0), "secondj1": (1, 1)}


def _positional(op: BinaryOp, i, j, zt):
    """FIRSTI/SECONDI give i, FIRSTJ/SECONDJ j, the *1 forms plus one (in
    eWise both operands sit at the same (i, j))."""
    axis, plus = _POS[op.positional]
    return cast((i, j)[axis] + plus, zt)


def _positional_vals(op: BinaryOp, keys, veclen: int, orient: str, zt):
    vec, idx = keys // veclen, keys % veclen
    i, j = (vec, idx) if orient == ROW else (idx, vec)
    return _positional(op, i, j, zt)


def _fill(s, like: torch.Tensor) -> torch.Tensor:
    """An eWiseUnion fill scalar as a 0-d tensor of ``like``'s type."""
    if isinstance(s, torch.Tensor):
        return T.cast(s.to(like.device), T.lookup(like.dtype))
    return T.scalar(0 if s is None else s, T.lookup(like.dtype), like.device)


def _apply(op, mode, zt, av, bv, a_in, b_in, alpha, beta):
    """z over the union (add, union) or where both are present (mult):
    the operator where both sides are present; under add, the present
    side's value elsewhere; under union, the operator on the fill."""
    if mode == "union":
        av = T.where(a_in, av, _fill(alpha, av))
        bv = T.where(b_in, bv, _fill(beta, bv))
    zv = cast(op.fn(av, bv), zt)
    if mode == "add":
        zv = T.where(a_in & b_in, zv, T.where(a_in, cast(av, zt),
                                                cast(bv, zt)))
    return zv


def _ewise(A, B, op, mode, alpha=None, beta=None, *, C=None, mask=None,
           accum=None, desc=NULL, out_dtype=None):
    A = maybe_transpose(A.wait(), desc.transpose0)
    B = maybe_transpose(B.wait(), desc.transpose1)
    if A.shape != B.shape:
        raise E.DimensionMismatch(f"{A.shape} vs {B.shape}")
    zt = op.out_type(A.dtype, B.dtype)
    dense = (A.fmt in (BITMAP, FULL) or B.fmt in (BITMAP, FULL)
             or mask is not None and mask.fmt in (BITMAP, FULL))
    if dense:
        CFG.burble("ewise_%s: dense path", mode)
        Tm = _ewise_dense(A, B, op, mode, zt, alpha, beta)
    else:
        CFG.burble("ewise_%s: sparse merge path", mode)
        Tm = _ewise_sparse(A, B, op, mode, zt, alpha, beta)
    klass = Vector if (isinstance(A, Vector) and isinstance(B, Vector)
                       and C is None) else None
    return writeback(C, mask, accum, Tm, desc, out_dtype, out_class=klass)


def _ewise_dense(A, B, op, mode, zt, alpha, beta):
    av, ap = A.to_dense_pair()
    bv, bp = B.to_dense_pair()
    pat = ap & bp if mode == "mult" else ap | bp
    if op.positional:
        ii = torch.arange(A.nrows, device=A.device)[:, None]
        jj = torch.arange(A.ncols, device=A.device)[None, :]
        zv = _positional(op, *torch.broadcast_tensors(ii, jj), zt)
    else:
        zv = _apply(op, mode, zt, av, bv, ap, bp, alpha, beta)
    zv = T.where(pat, zv, torch.zeros((), dtype=zv.dtype, device=A.device))
    return Matrix(A.shape, zt, BITMAP, A.orient, values=zv, bitmap=pat)


def _ewise_sparse(A, B, op, mode, zt, alpha, beta):
    orient = A.orient
    B = B.to_orient(orient)
    A = A.to_format(SPARSE) if A.fmt == HYPER else A
    B = B.to_format(SPARSE) if B.fmt == HYPER else B
    ak, avals = _keys_of(A)
    bk, bvals = _keys_of(B)
    veclen, nvec = A._veclen(), A._nvec_dim()
    ukeys, uav, ubv, a_in, b_in = K.union_merge(ak, avals, bk, bvals)
    if mode == "mult":
        _, (ukeys, uav, ubv, a_in, b_in) = K.compact(
            a_in & b_in, ukeys, uav, ubv, a_in, b_in)
    if op.positional:
        zv = _positional_vals(op, ukeys, veclen, orient, zt)
    else:
        zv = _apply(op, mode, zt, uav, ubv, a_in, b_in, alpha, beta)
    uvec, uidx = K.key_split(ukeys, veclen)
    indptr = K.indptr_from_sorted(uvec, nvec, INDEX)
    return Matrix(A.shape, zt, SPARSE, orient, indptr=indptr, indices=uidx,
                  values=zv)


def ewise_add(A: Matrix, B: Matrix, op: BinaryOp, **kw):
    """GrB_eWiseAdd: set-union apply (reference: Source/GB_add.h); span
    ``ewise.add``."""
    with CFG.timed("ewise.add", A.device):
        return _ewise(A, B, op, "add", **kw)


def ewise_mult(A: Matrix, B: Matrix, op: BinaryOp, **kw):
    """GrB_eWiseMult: set-intersection apply (reference:
    Source/GB_emult.h)."""
    return _ewise(A, B, op, "mult", **kw)


def ewise_union(A: Matrix, alpha, B: Matrix, beta, op: BinaryOp, **kw):
    """GxB_eWiseUnion: union with per-side fill scalars."""
    return _ewise(A, B, op, "union", alpha=alpha, beta=beta, **kw)
