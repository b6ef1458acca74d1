"""Descriptors — per-call option block (counterpart of
``graphblas_tpu.core.descriptor``; reference: GrB_Descriptor,
Source/Shared/GB_opaque.h:444-457).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Descriptor:
    # GrB_OUTP = GrB_REPLACE: clear C first (only where mask allows writes).
    replace: bool = False
    # GrB_MASK = GrB_COMP: use the complement of the mask.
    mask_complement: bool = False
    # GrB_MASK = GrB_STRUCTURE: use the mask's pattern, not its values.
    mask_structure: bool = False
    # GrB_INP0/INP1 = GrB_TRAN.
    transpose0: bool = False
    transpose1: bool = False
    # GxB_AxB_METHOD hint: None|'dot'|'saxpy'|'gustavson'|'hash'|'dense'.
    axb_method: str | None = None

    def with_(self, **kw) -> "Descriptor":
        return dataclasses.replace(self, **kw)


NULL = Descriptor()
T0 = Descriptor(transpose0=True)
T1 = Descriptor(transpose1=True)
T0T1 = Descriptor(transpose0=True, transpose1=True)
C = Descriptor(mask_complement=True)
S = Descriptor(mask_structure=True)
SC = Descriptor(mask_complement=True, mask_structure=True)
R = Descriptor(replace=True)
RC = Descriptor(replace=True, mask_complement=True)
RS = Descriptor(replace=True, mask_structure=True)
RSC = Descriptor(replace=True, mask_structure=True, mask_complement=True)
