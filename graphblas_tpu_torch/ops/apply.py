"""GrB_apply: unary / bound-binary / index-unary operator application
(counterpart of ``graphblas_tpu.ops.apply``; reference:
Source/GB_apply_op.c).

The pattern is unchanged, so apply is one elementwise map over the values
tensor (plus coordinate streams for positional/index ops)."""

from __future__ import annotations

import numpy as np
import torch

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..core.convert import _clone
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import BITMAP, FULL, HYPER, SPARSE, Matrix
from ..core.ops import BinaryOp, IndexUnaryOp, UnaryOp
from ..core.types import cast
from .masker import writeback
from .transpose import maybe_transpose


def _coords_dense(A):
    ii = torch.arange(A.nrows, dtype=torch.int64,
                      device=A.device)[:, None].expand(A.shape)
    jj = torch.arange(A.ncols, dtype=torch.int64,
                      device=A.device)[None, :].expand(A.shape)
    return ii, jj


def _bound_scalar(s, A) -> torch.Tensor:
    """The bound scalar of a binary apply as a 0-d tensor on A's device
    (a Python float is FP64, as under the JAX package's x64 mode)."""
    if isinstance(s, torch.Tensor):
        return s.to(A.device)
    return T.scalar(s, T.lookup(np.asarray(s).dtype), A.device)


def apply(A: Matrix, op, *, bind=None, thunk=None, C=None, mask=None,
          accum=None, desc: Descriptor = NULL, out_dtype=None):
    """op: UnaryOp | IndexUnaryOp | BinaryOp (with bind=("first", s) or
    ("second", s))."""
    A = maybe_transpose(A, desc.transpose0)
    klass = type(A) if C is None else None
    if isinstance(op, UnaryOp):
        zt = T.lookup(out_dtype) if out_dtype else op.out_type(A.dtype)
        Tm = _apply_unary(A, op, zt)
    elif isinstance(op, IndexUnaryOp):
        zt = T.lookup(out_dtype) if out_dtype else op.out_type(A.dtype)
        Tm = _apply_idx(A, op, thunk, zt)
    elif isinstance(op, BinaryOp):
        if op.positional:
            # positional binary ops ignore the bound scalar and read the
            # entry's own indices (reference: GB_apply_op.c)
            pos = {"firsti": "i", "secondi": "i", "firsti1": "i1",
                   "secondi1": "i1", "firstj": "j", "secondj": "j",
                   "firstj1": "j1", "secondj1": "j1"}[op.positional]
            zt = T.lookup(out_dtype) if out_dtype else T.INT64
            fn = (lambda v: v + 1) if pos.endswith("1") else (lambda v: v)
            Tm = _apply_positional(
                A, UnaryOp(op.name, fn, ztype=zt, positional=pos), zt)
        else:
            if bind is None:
                raise E.InvalidValue(
                    "binary apply requires bind=('first'|'second', scalar)")
            which, s = bind
            st = _bound_scalar(s, A)
            sty = T.lookup(st.dtype)
            if which == "first":
                zt = T.lookup(out_dtype) if out_dtype else \
                    op.out_type(sty, A.dtype)
                fn = lambda x: op.fn(st, x)         # noqa: E731
            else:
                zt = T.lookup(out_dtype) if out_dtype else \
                    op.out_type(A.dtype, sty)
                fn = lambda x: op.fn(x, st)         # noqa: E731
            Tm = _apply_unary(A, UnaryOp("bound", fn, ztype=zt), zt)
    else:
        raise E.InvalidValue(f"bad op for apply: {op!r}")
    return writeback(C, mask, accum, Tm, desc, out_dtype, out_class=klass)


def _apply_unary(A, op, zt):
    CFG.burble("apply %s (%s)", op.name, A.fmt)
    if op.positional:
        return _apply_positional(A, op, zt)
    if A.fmt in (BITMAP, FULL):
        v, p = A.to_dense_pair()
        zv = torch.where(p, cast(op.fn(v), zt),
                         torch.zeros((), dtype=zt.torch_dtype,
                                     device=A.device))
        return Matrix(A.shape, zt, A.fmt, A.orient, values=zv,
                      bitmap=p if A.fmt == BITMAP else None)
    # sparse/hyper: map the (possibly iso) values tensor directly
    return _clone(A, dtype=zt, values=cast(op.fn(A.values), zt))


def _apply_positional(A, op, zt):
    if A.fmt in (BITMAP, FULL):
        ii, jj = _coords_dense(A)
        src = {"i": ii, "i1": ii, "j": jj, "j1": jj}[op.positional]
        _, p = A.to_dense_pair()
        return Matrix(A.shape, zt, A.fmt, A.orient,
                      values=cast(op.fn(src), zt),
                      bitmap=p if A.fmt == BITMAP else None)
    S = A.to_format(SPARSE) if A.fmt == HYPER else A
    rows, cols = S._coords()
    src = {"i": rows, "i1": rows, "j": cols, "j1": cols}[op.positional]
    return _clone(S, dtype=zt, values=cast(op.fn(src.long()), zt),
                  iso=False)


def _apply_idx(A, op, thunk, zt):
    th = torch.as_tensor(0 if thunk is None else thunk, device=A.device)
    if A.fmt in (BITMAP, FULL):
        ii, jj = _coords_dense(A)
        v, p = A.to_dense_pair()
        zv = torch.where(p, cast(op.fn(v, ii, jj, th), zt),
                         torch.zeros((), dtype=zt.torch_dtype,
                                     device=A.device))
        return Matrix(A.shape, zt, A.fmt, A.orient, values=zv,
                      bitmap=p if A.fmt == BITMAP else None)
    S = A.to_format(SPARSE) if A.fmt == HYPER else A
    rows, cols = S._coords()
    zv = cast(op.fn(S._vals_expanded(), rows.long(), cols.long(), th), zt)
    return _clone(S, dtype=zt, values=zv, iso=False)
