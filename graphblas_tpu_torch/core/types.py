"""GraphBLAS type system on torch dtypes (counterpart of
``graphblas_tpu.core.types``).

The reference defines 13 built-in types (reference:
Include/GraphBLAS.h:630-643).  A ``Type`` names one of them and carries
both its numpy dtype (host side, plans, interop) and its torch dtype
(device side).  Casting follows the reference: float->integer rounds to
nearest (nearbyint) with NaN -> 0 and clamping, anything->bool is x != 0.

UINT16/UINT32/UINT64 are declared, but torch on the CPU has no add or min
for them; arithmetic on those types raises ``NotImplementedError`` (see
``core/ops.py``) until a wider carrier lands.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Type:
    """A GraphBLAS scalar type (reference: GrB_Type, Source/GB_opaque.h)."""

    name: str
    dtype: np.dtype          # numpy dtype
    torch_dtype: torch.dtype

    @property
    def np_dtype(self):
        return np.dtype(self.dtype)

    @property
    def is_float(self) -> bool:
        return np.issubdtype(self.np_dtype, np.floating)

    @property
    def is_complex(self) -> bool:
        return np.issubdtype(self.np_dtype, np.complexfloating)

    @property
    def is_integer(self) -> bool:
        return np.issubdtype(self.np_dtype, np.integer)

    @property
    def is_bool(self) -> bool:
        return self.np_dtype == np.bool_

    @property
    def is_signed(self) -> bool:
        return np.issubdtype(self.np_dtype, np.signedinteger)

    def __repr__(self):
        return f"Type({self.name})"


# The 13 built-in types (reference: Include/GraphBLAS.h:630-643).
BOOL = Type("GrB_BOOL", np.dtype(np.bool_), torch.bool)
INT8 = Type("GrB_INT8", np.dtype(np.int8), torch.int8)
INT16 = Type("GrB_INT16", np.dtype(np.int16), torch.int16)
INT32 = Type("GrB_INT32", np.dtype(np.int32), torch.int32)
INT64 = Type("GrB_INT64", np.dtype(np.int64), torch.int64)
UINT8 = Type("GrB_UINT8", np.dtype(np.uint8), torch.uint8)
UINT16 = Type("GrB_UINT16", np.dtype(np.uint16), torch.uint16)
UINT32 = Type("GrB_UINT32", np.dtype(np.uint32), torch.uint32)
UINT64 = Type("GrB_UINT64", np.dtype(np.uint64), torch.uint64)
FP32 = Type("GrB_FP32", np.dtype(np.float32), torch.float32)
FP64 = Type("GrB_FP64", np.dtype(np.float64), torch.float64)
FC32 = Type("GxB_FC32", np.dtype(np.complex64), torch.complex64)
FC64 = Type("GxB_FC64", np.dtype(np.complex128), torch.complex128)

ALL_TYPES = [BOOL, INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64,
             FP32, FP64, FC32, FC64]

# torch dtypes whose arithmetic torch does not implement on the CPU
UNSIGNED_WIDE = (torch.uint16, torch.uint32, torch.uint64)

_BY_NP = {t.np_dtype: t for t in ALL_TYPES}
_BY_TORCH = {t.torch_dtype: t for t in ALL_TYPES}
_BY_NAME = {t.name: t for t in ALL_TYPES}


def lookup(x) -> Type:
    """Resolve a Type from a Type / torch dtype / numpy dtype-like / name /
    tensor."""
    if isinstance(x, Type):
        return x
    if isinstance(x, torch.dtype):
        try:
            return _BY_TORCH[x]
        except KeyError:
            raise KeyError(f"no GraphBLAS type for {x!r}") from None
    if isinstance(x, torch.Tensor):
        return lookup(x.dtype)
    if isinstance(x, str) and x in _BY_NAME:
        return _BY_NAME[x]
    try:
        dt = np.dtype(x)
    except TypeError:
        dt = np.dtype(x.dtype)
    try:
        return _BY_NP[dt]
    except KeyError:
        raise KeyError(f"no GraphBLAS type for dtype {dt!r}") from None


def scalar(value, ty: Type, device) -> torch.Tensor:
    """A 0-d tensor of type ``ty`` on ``device`` (explicit dtype: torch's
    default float is float32, the JAX package's is float64)."""
    return torch.tensor(np.asarray(value, ty.np_dtype).item(),
                        dtype=ty.torch_dtype, device=device)


def cast(value: torch.Tensor, to) -> torch.Tensor:
    """GraphBLAS typecast (reference: Source/GB_casting.h).  Returns the
    input object itself when it already has the target dtype (callers key
    plan caches on tensor identity)."""
    to = lookup(to)
    src = value
    if src.dtype == to.torch_dtype:
        return src
    if to.is_bool:
        return src != 0
    if to.is_integer and (src.is_floating_point() or src.is_complex()):
        real = src.real if src.is_complex() else src
        info = np.iinfo(to.np_dtype)
        # nearbyint + clamp to the target range, NaN -> 0 (reference
        # GB_casting.h GB_cast_to_int*)
        r = torch.round(real)
        r = torch.where(torch.isnan(real), torch.zeros_like(r), r)
        r = torch.clamp(r, float(info.min), float(info.max))
        return r.to(to.torch_dtype)
    if not to.is_complex and src.is_complex():
        return src.real.to(to.torch_dtype)
    return src.to(to.torch_dtype)


def upcast_pair(a: Type, b: Type) -> Type:
    """Type of a op b under numpy promotion (the JAX package's rule, so
    both packages pick the same output type)."""
    return lookup(np.promote_types(a.np_dtype, b.np_dtype))
