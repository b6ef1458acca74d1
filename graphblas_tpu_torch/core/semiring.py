"""Semirings: (add monoid, multiply binop) — counterpart of
``graphblas_tpu.core.semiring`` (reference: GrB_Semiring,
Source/Shared/GB_opaque.h:428-442).

Operators are dtype-polymorphic callables, so every (monoid, binop) pair
exists through ``semiring()``; the workhorse semirings get module-level
names; ``core/names.py`` resolves the 1553 predefined typed names.
"""

from __future__ import annotations

import dataclasses

from . import monoid as M
from . import ops as OPS
from .monoid import Monoid
from .ops import BinaryOp


@dataclasses.dataclass(frozen=True)
class Semiring:
    add: Monoid
    mult: BinaryOp
    name: str = ""
    # declared type of a NAMED semiring (the T of GxB_add_mult_T: the type
    # of x, y and the monoid; core/names.py); None => dtype-polymorphic
    declared_type: object = None

    def __post_init__(self):
        if not self.name:
            object.__setattr__(
                self, "name",
                f"{self.add.op.name.split('_')[-1]}_"
                f"{self.mult.name.split('_')[-1]}")

    def __repr__(self):
        return f"Semiring({self.name})"


def semiring(add: Monoid, mult: BinaryOp, name: str = "") -> Semiring:
    """Construct any semiring (reference: GrB_Semiring_new)."""
    return Semiring(add, mult, name=name)


# The workhorses (reference nomenclature: GrB_PLUS_TIMES_SEMIRING_* etc.)
PLUS_TIMES = Semiring(M.PLUS, OPS.TIMES, "PLUS_TIMES")
MIN_PLUS = Semiring(M.MIN, OPS.PLUS, "MIN_PLUS")
MAX_PLUS = Semiring(M.MAX, OPS.PLUS, "MAX_PLUS")
MIN_TIMES = Semiring(M.MIN, OPS.TIMES, "MIN_TIMES")
MIN_MAX = Semiring(M.MIN, OPS.MAX, "MIN_MAX")
MAX_MIN = Semiring(M.MAX, OPS.MIN, "MAX_MIN")
MAX_TIMES = Semiring(M.MAX, OPS.TIMES, "MAX_TIMES")
PLUS_MIN = Semiring(M.PLUS, OPS.MIN, "PLUS_MIN")
LOR_LAND = Semiring(M.LOR, OPS.LAND, "LOR_LAND")
LAND_LOR = Semiring(M.LAND, OPS.LOR, "LAND_LOR")
LXOR_LAND = Semiring(M.LXOR, OPS.LAND, "LXOR_LAND")
ANY_PAIR = Semiring(M.ANY, OPS.PAIR, "ANY_PAIR")
PLUS_PAIR = Semiring(M.PLUS, OPS.PAIR, "PLUS_PAIR")
PLUS_FIRST = Semiring(M.PLUS, OPS.FIRST, "PLUS_FIRST")
PLUS_SECOND = Semiring(M.PLUS, OPS.SECOND, "PLUS_SECOND")
MIN_FIRST = Semiring(M.MIN, OPS.FIRST, "MIN_FIRST")
MIN_SECOND = Semiring(M.MIN, OPS.SECOND, "MIN_SECOND")
MAX_FIRST = Semiring(M.MAX, OPS.FIRST, "MAX_FIRST")
MAX_SECOND = Semiring(M.MAX, OPS.SECOND, "MAX_SECOND")
ANY_SECOND = Semiring(M.ANY, OPS.SECOND, "ANY_SECOND")
ANY_FIRST = Semiring(M.ANY, OPS.FIRST, "ANY_FIRST")
# BFS-parent style semirings (positional multiply)
MIN_SECONDI = Semiring(M.MIN, OPS.SECONDI, "MIN_SECONDI")
MIN_SECONDI1 = Semiring(M.MIN, OPS.SECONDI1, "MIN_SECONDI1")
ANY_SECONDI = Semiring(M.ANY, OPS.SECONDI, "ANY_SECONDI")
MIN_FIRSTJ = Semiring(M.MIN, OPS.FIRSTJ, "MIN_FIRSTJ")
MIN_FIRSTJ1 = Semiring(M.MIN, OPS.FIRSTJ1, "MIN_FIRSTJ1")
# bitwise
BOR_BAND = Semiring(M.BOR, OPS.BAND, "BOR_BAND")
BAND_BOR = Semiring(M.BAND, OPS.BOR, "BAND_BOR")
BXOR_BAND = Semiring(M.BXOR, OPS.BAND, "BXOR_BAND")
