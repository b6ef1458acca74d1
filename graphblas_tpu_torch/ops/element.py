"""Element access: extractElement / isStoredElement (counterpart of
``graphblas_tpu.ops.element``; reference: Source/GB_Element.h,
GB_setElement.c — set/remove live on Matrix through the pending queue).
A lookup reads a few values to the host: one vector's slice of indices,
or one bitmap bit."""

from __future__ import annotations

import numpy as np

from ..core import errors as E
from ..core import types as T
from ..core.matrix import BITMAP, FULL, HYPER, ROW


def _locate(A, i, j):
    """(found, flat position into A.indices) for the sparse formats."""
    vec, idx = (i, j) if A.orient == ROW else (j, i)
    if A.fmt == HYPER:
        # the hyper-hash analog (reference: GB_hyper_hash_lookup.h): look
        # vec up in the hyperlist, no hyper -> sparse conversion
        hh = A.h.cpu().numpy()
        p = int(np.searchsorted(hh, vec))
        if p >= len(hh) or hh[p] != vec:
            return False, 0
        vec = p
    lo, hi = (int(x) for x in A.indptr[vec:vec + 2].cpu())
    if lo == hi:
        return False, 0
    seg = A.indices[lo:hi].cpu().numpy()
    p = int(np.searchsorted(seg, idx))
    if p < len(seg) and seg[p] == idx:
        return True, lo + p
    return False, 0


def _check(A, i, j):
    if not (0 <= i < A.nrows and 0 <= j < A.ncols):
        raise E.InvalidIndex(f"({i},{j}) outside {A.shape}")


def _value(A, at):
    """The stored value at ``at`` (an index into A.values) as a numpy
    scalar of A's type."""
    v = A.values.reshape(-1)[0] if A.iso else A.values[at]
    return T.host(v)[()]


def is_stored(A, i, j) -> bool:
    i, j = int(i), int(j)
    _check(A, i, j)
    if A.fmt == FULL:
        return True
    if A.fmt == BITMAP:
        return bool(A.bitmap[i, j])
    return _locate(A, i, j)[0]


def extract_element(A, i, j):
    i, j = int(i), int(j)
    _check(A, i, j)
    if A.fmt in (BITMAP, FULL):
        if A.fmt == BITMAP and not bool(A.bitmap[i, j]):
            raise E.NoValue((i, j))
        return _value(A, (i, j))
    found, pos = _locate(A, i, j)
    if not found:
        raise E.NoValue((i, j))
    return _value(A, pos)
