"""Monoids: an associative commutative BinaryOp + identity (+ optional
terminal) — counterpart of ``graphblas_tpu.core.monoid`` (reference:
Source/Shared/GB_opaque.h:411-426, built-ins in Source/GB_ops.c:584-660).

Identity and terminal depend on the dtype (MIN's identity is +inf for
floats, INT_MAX for ints, 2^64 - 1 for UINT64), so they are functions of a
numpy dtype here, typed numpy scalars (a bare Python int would not say
UINT64); ``identity_tensor`` makes the 0-d device tensor a kernel needs
(an unsigned one is carried as ``types.carry`` says: UINT64's 2^64 - 1 is
-1 in its int64 carrier).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import ops as OPS
from . import types as T
from .ops import BinaryOp


def _id_const(c):
    return lambda dt: np.dtype(dt).type(c)


def _minident(dt):
    dt = np.dtype(dt)
    if np.issubdtype(dt, np.floating):
        return dt.type(np.inf)
    if dt == np.bool_:
        return np.True_
    return dt.type(np.iinfo(dt).max)


def _maxident(dt):
    dt = np.dtype(dt)
    if np.issubdtype(dt, np.floating):
        return dt.type(-np.inf)
    if dt == np.bool_:
        return np.False_
    return dt.type(np.iinfo(dt).min)


def _allbits(dt):
    dt = np.dtype(dt)
    return dt.type(-1) if np.issubdtype(dt, np.signedinteger) \
        else dt.type(np.iinfo(dt).max)


@dataclasses.dataclass(frozen=True)
class Monoid:
    """(op, identity[, terminal]) — reference: GrB_Monoid."""

    op: BinaryOp
    identity: Callable[[np.dtype], np.generic]  # dtype -> scalar
    terminal: Optional[Callable[[np.dtype], np.generic]] = None
    name: str = ""
    # declared domain of a NAMED monoid (e.g. GxB_MIN_UINT64_MONOID, see
    # core/names.py); None => dtype-polymorphic
    declared_type: object = None

    def __post_init__(self):
        if not self.name:
            object.__setattr__(self, "name", self.op.name + "_MONOID")

    def __call__(self, x, y):
        return self.op(x, y)

    def identity_for(self, dtype):
        return self.identity(np.dtype(dtype))

    def terminal_for(self, dtype):
        return None if self.terminal is None else self.terminal(
            np.dtype(dtype))

    def identity_tensor(self, ty: T.Type, device) -> torch.Tensor:
        """The identity on ``device``: 0-d, or of a struct's field shape
        (a struct monoid's identity is an array)."""
        ident = np.asarray(self.identity_for(ty.np_dtype))
        if ident.ndim:
            return torch.from_numpy(ident.astype(ty.np_dtype)).to(device)
        return T.scalar(ident, ty, device)

    def __repr__(self):
        return f"Monoid({self.name})"


def monoid(op: BinaryOp, identity, terminal=None, name="") -> Monoid:
    """User-defined monoid (reference: GrB_Monoid_new).  ``identity`` and
    ``terminal`` may be scalars or dtype->scalar callables."""
    idf = identity if callable(identity) else _id_const(identity)
    tf = None if terminal is None else (
        terminal if callable(terminal) else _id_const(terminal))
    return Monoid(op, idf, tf, name=name or f"{op.name}_MONOID")


# Built-in monoids (reference: Source/GB_ops.c:584-660).
PLUS = Monoid(OPS.PLUS, _id_const(0), name="GrB_PLUS_MONOID")
TIMES = Monoid(OPS.TIMES, _id_const(1),
               terminal=lambda dt: (np.dtype(dt).type(0)
                                    if np.issubdtype(np.dtype(dt), np.integer)
                                    else None),
               name="GrB_TIMES_MONOID")
MIN = Monoid(OPS.MIN, _minident, terminal=_maxident, name="GrB_MIN_MONOID")
MAX = Monoid(OPS.MAX, _maxident, terminal=_minident, name="GrB_MAX_MONOID")
ANY = Monoid(OPS.ANY, _id_const(0), terminal=_id_const(0),
             name="GxB_ANY_MONOID")
LOR = Monoid(OPS.LOR, _id_const(False), terminal=_id_const(True),
             name="GrB_LOR_MONOID")
LAND = Monoid(OPS.LAND, _id_const(True), terminal=_id_const(False),
              name="GrB_LAND_MONOID")
LXOR = Monoid(OPS.LXOR, _id_const(False), name="GrB_LXOR_MONOID")
LXNOR = Monoid(OPS.LXNOR, _id_const(True), name="GrB_LXNOR_MONOID")
EQ = LXNOR
BOR = Monoid(OPS.BOR, _id_const(0), terminal=_allbits, name="GxB_BOR_MONOID")
BAND = Monoid(OPS.BAND, _allbits, terminal=_id_const(0),
              name="GxB_BAND_MONOID")
BXOR = Monoid(OPS.BXOR, _id_const(0), name="GxB_BXOR_MONOID")
BXNOR = Monoid(OPS.BXNOR, _allbits, name="GxB_BXNOR_MONOID")

ALL_MONOIDS = [PLUS, TIMES, MIN, MAX, ANY, LOR, LAND, LXOR, LXNOR,
               BOR, BAND, BXOR, BXNOR]
