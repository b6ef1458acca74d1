"""GrB_reduce: matrix -> vector (row-wise monoid reduce) and matrix/vector
-> scalar (counterpart of ``graphblas_tpu.ops.reduce``; reference:
Source/GB_reduce_to_scalar.c, GB_reduce_to_vector.c).  The terminal
early-exit of the scalar reduce comes later."""

from __future__ import annotations

import numpy as np
import torch

from ..core import config as CFG
from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import BITMAP, FULL, HYPER, ROW, SPARSE, Matrix, Vector
from ..core.monoid import Monoid
from ..core.types import cast
from ..kernels import segment as K
from .masker import writeback
from .transpose import maybe_transpose


def reduce_to_vector(A: Matrix, mon: Monoid, *, C=None, mask=None,
                     accum=None, desc: Descriptor = NULL, out_dtype=None):
    """w<m> = accum(w, reduce_rows(A)) — reduce each row of A."""
    A = maybe_transpose(A, desc.transpose0)
    dt = A.dtype
    CFG.burble("reduce_to_vector %s (%s)", mon.name, A.fmt)
    zero = torch.zeros((), dtype=dt.torch_dtype, device=A.device)
    if A.fmt in (BITMAP, FULL):
        v, p = A.to_dense_pair()
        m, n = A.shape
        rows = torch.arange(m, device=A.device).repeat_interleave(n)
        keep = p.reshape(-1)
        out = K.segment_reduce(T.take(v.reshape((-1,) + dt.shape), keep),
                               rows[keep], m, mon)
        present = p.any(dim=1)
    else:
        S = A.to_format(SPARSE) if A.fmt == HYPER else A
        rows, _ = S._coords()
        out = K.segment_reduce(S._vals_expanded(), rows, A.nrows, mon,
                               indices_are_sorted=S.orient == ROW)
        present = torch.zeros(A.nrows, dtype=torch.bool, device=A.device)
        present[rows.long()] = True
    Tm = Vector((A.nrows, 1), dt, BITMAP,
                values=T.where(present, out, zero)[:, None],
                bitmap=present[:, None])
    return writeback(C, mask, accum, Tm, desc, out_dtype, out_class=Vector)


def reduce_to_scalar(A: Matrix, mon: Monoid, *, accum=None, init=None,
                     out_dtype=None):
    """s = accum(s, reduce_all(A)).  An empty matrix reduces to the monoid
    identity.  Returns a numpy scalar."""
    dt = T.lookup(out_dtype) if out_dtype else A.dtype
    CFG.burble("reduce_to_scalar %s (%s)", mon.name, A.fmt)
    if A.fmt in (BITMAP, FULL):
        v, p = A.to_dense_pair()
        vals = T.take(cast(v, dt), p)
    else:
        vals = cast(A._vals_expanded(), dt)
    r = K.full_reduce(vals, mon, dt)
    if accum is not None and init is not None:
        r = cast(accum.fn(T.scalar(init, dt, r.device), r), dt)
    return np.asarray(T.host(r))[()]

