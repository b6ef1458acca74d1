"""GraphBLAS type system on torch dtypes (counterpart of
``graphblas_tpu.core.types``).

The reference defines 13 built-in types (reference:
Include/GraphBLAS.h:630-643).  A ``Type`` names one of them and carries
both its numpy dtype (host side, plans, interop) and its torch dtype
(device side).  Casting follows the reference: float->integer rounds to
nearest (nearbyint) with NaN -> 0 and clamping, anything->bool is x != 0.

UINT16/UINT32/UINT64 values are stored in torch's unsigned dtypes (so a
tensor names its type), but torch computes almost nothing on them: no
add, compare or scatter on the CPU, and on the card not even a gather,
``where`` or sort (``tools/probe_unsigned.py``).  Every op computes
through a signed carrier (``carry``/``uncarry``): UINT16 in int32 and
UINT32 in int64, wrapped with a mask; UINT64 as its int64 bit pattern,
ordered by ``order_key`` (the sign bit flipped).  Data moves through the
same-width signed view (``bits``/``unbits``, ``take``, ``where``).

GxB_BF16 is the JAX package's TPU extension (not in the reference).
numpy has no bfloat16 without ``ml_dtypes``, which the port does not
use, so a BF16 array crosses to the host as float32, which holds every
bf16 value exactly (``host``/``from_host``): ``to_scipy``, the values of
``from_coo``, scalars read back.  The JAX package hands out
``ml_dtypes.bfloat16`` arrays there.  PLUS reductions of BF16 (the row
and scalar reduce, and the sums of mxv/vxm/mxm) add in float32 and round
once to bf16; the JAX package adds in bf16, so the two agree bitwise
only where every partial sum is exact in bf16.

A user-defined struct type (``struct_type``; reference: GrB_Type_new, as
in Demo gauss_demo.c / wildtype_demo.c) has a field shape: its values
are tensors of the field dtype with trailing dims ``shape``, stored
(nnz, *shape) in the sparse formats and (nrows, ncols, *shape) in the
dense ones, and it casts only to itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Type:
    """A GraphBLAS scalar type (reference: GrB_Type, Source/GB_opaque.h)."""

    name: str
    dtype: np.dtype          # numpy dtype (of a struct's fields)
    torch_dtype: torch.dtype
    shape: tuple = ()        # a struct type's field shape

    @property
    def is_struct(self) -> bool:
        return bool(self.shape)

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
        return self.np_dtype == np.bool_ and not self.shape

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

# bfloat16, its host carrier float32 (see the module docstring); as in the
# JAX package it is found by name and dtype but is not in ALL_TYPES
BF16 = Type("GxB_BF16", np.dtype(np.float32), torch.bfloat16)

# the carriers of the unsigned dtypes torch cannot compute on, and their
# same-width signed views
_CARRIER = {torch.uint16: torch.int32, torch.uint32: torch.int64,
            torch.uint64: torch.int64}
_SIGNED = {torch.uint16: torch.int16, torch.uint32: torch.int32,
           torch.uint64: torch.int64}
_MASK = {torch.uint16: 0xFFFF, torch.uint32: 0xFFFFFFFF}
TOP = -(1 << 63)          # the int64 sign bit

_BY_NP = {t.np_dtype: t for t in ALL_TYPES}
_BY_TORCH = {t.torch_dtype: t for t in ALL_TYPES + [BF16]}
_BY_NAME = {t.name: t for t in ALL_TYPES + [BF16]}


_STRUCTS: dict = {}      # struct types by name, as they are made


def struct_type(name: str, dtype, shape) -> Type:
    """A user-defined struct type of fields ``dtype`` with field shape
    ``shape`` (e.g. (2,) for a gauss integer, (4, 4) for wildtype).  It is
    found by name afterwards (``lookup``)."""
    np_dt = np.dtype(dtype)
    ty = Type(name, np_dt, _BY_NP[np_dt].torch_dtype,
              tuple(int(d) for d in shape))
    _STRUCTS[name] = ty
    return ty


def lookup(x) -> Type:
    """Resolve a Type from a Type / torch dtype / numpy dtype-like / name /
    tensor."""
    if isinstance(x, Type):
        return x
    if isinstance(x, str) and x in _STRUCTS:
        return _STRUCTS[x]
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
        if isinstance(x, str):
            raise KeyError(f"no GraphBLAS type named {x!r}") from None
        dt = np.dtype(x.dtype)
    if dt.name == "bfloat16":          # an ml_dtypes array, where present
        return BF16
    try:
        return _BY_NP[dt]
    except KeyError:
        raise KeyError(f"no GraphBLAS type for dtype {dt!r}") from None


def host(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array: BF16 as its float32 carrier,
    the unsigned types through their signed views.  Never the tensor's
    own storage: a write into a host array would pass torch's in-place
    write counter, which the caches of utils/tensor_cache.py check."""
    on_host = t.device.type == "cpu"
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy()
    arr = bits(t).numpy().view(lookup(t.dtype).np_dtype)
    return arr.copy() if on_host else arr


def from_host(arr, ty: Type, device) -> torch.Tensor:
    """A numpy array (of ``ty``'s host dtype) as a tensor of ``ty`` on
    ``device``."""
    arr = np.array(arr, dtype=ty.np_dtype, order="C")    # a 0-d stays 0-d
    return torch.from_numpy(arr).to(device).to(ty.torch_dtype)


def wide_unsigned(dt) -> bool:
    """True for uint16/uint32/uint64 (a torch dtype or a Type)."""
    return (dt.torch_dtype if isinstance(dt, Type) else dt) in _CARRIER


def carry(x: torch.Tensor) -> torch.Tensor:
    """The carrier of an unsigned tensor (UINT16 -> int32, UINT32 -> int64
    by value, UINT64 -> its int64 bit pattern); other tensors as they
    are."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64)
    if x.dtype in _CARRIER:
        return bits(x).to(_CARRIER[x.dtype]) & _MASK[x.dtype]
    return x


def uncarry(c: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Carrier -> unsigned ``dt``, wrapping modulo 2^w."""
    if dt == torch.uint64:
        return c.to(torch.int64).view(torch.uint64)
    return c.to(_SIGNED[dt]).view(dt)


def order_key(c: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """A signed tensor that orders like the unsigned values carried in
    ``c`` (carriers of UINT16/UINT32 already do)."""
    return c ^ TOP if dt == torch.uint64 else c


def bits(x: torch.Tensor) -> torch.Tensor:
    """The same-width signed view of an unsigned tensor (for moving data:
    gather, scatter, sort, where); other tensors as they are."""
    return x.view(_SIGNED[x.dtype]) if x.dtype in _SIGNED else x


def unbits(b: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return b.view(dt) if dt in _SIGNED else b


def take(x: torch.Tensor, idx) -> torch.Tensor:
    """``x[idx]`` for any dtype."""
    return unbits(bits(x)[idx], x.dtype)


def where(cond: torch.Tensor, a: torch.Tensor, b) -> torch.Tensor:
    """``torch.where`` for any dtype (``b`` may be a 0-d tensor of a's
    dtype); ``cond`` broadcasts over a struct's trailing field dims."""
    extra = a.dim() - cond.dim()
    if extra > 0:
        cond = cond.reshape(tuple(cond.shape) + (1,) * extra)
    if a.dtype not in _SIGNED:
        return torch.where(cond, a, b)
    return unbits(torch.where(cond, bits(a), bits(b)), a.dtype)


def scalar(value, ty: Type, device) -> torch.Tensor:
    """A 0-d tensor of type ``ty`` on ``device`` (explicit dtype: torch's
    default float is float32, the JAX package's is float64); for a
    struct type a tensor of its field shape."""
    if ty.shape:
        arr = np.broadcast_to(np.asarray(value).astype(ty.np_dtype),
                              ty.shape)
        return torch.from_numpy(arr.copy()).to(device)
    return torch.tensor(np.asarray(value, ty.np_dtype).item(),
                        dtype=ty.torch_dtype, device=device)


def cast(value: torch.Tensor, to) -> torch.Tensor:
    """GraphBLAS typecast (reference: Source/GB_casting.h).  Returns the
    input object itself when it already has the target dtype (callers key
    plan caches on tensor identity)."""
    to = lookup(to)
    src = value
    dt = to.torch_dtype
    if to.is_struct:
        # a struct casts only to itself (GB_casting.h): the source must
        # already carry the field dims
        k = len(to.shape)
        if src.dim() < k or tuple(src.shape[src.dim() - k:]) != to.shape:
            from .errors import DomainMismatch
            raise DomainMismatch(f"cannot cast shape {tuple(src.shape)} "
                                 f"to struct type {to.name}{to.shape}")
        return src if src.dtype == dt else src.to(dt)
    if src.dtype == dt:
        return src
    if to.is_bool:
        return bits(src) != 0
    if src.dtype == torch.uint64 and not to.is_integer:
        return _u64_to_float(src.view(torch.int64)).to(dt)
    src = carry(src)
    if to.is_integer and (src.is_floating_point() or src.is_complex()):
        return _float_to_int(src.real if src.is_complex() else src, to)
    if dt in _CARRIER:              # integer or bool -> unsigned: wraps
        return uncarry(src.to(torch.int64), dt)
    if not to.is_complex and src.is_complex():
        return src.real.to(dt)
    return src.to(dt)


def _u64_to_float(c: torch.Tensor) -> torch.Tensor:
    """float64 of the unsigned values whose bit patterns ``c`` holds, one
    rounding: (high 32 bits) * 2^32 exactly, plus the low 32 bits."""
    hi = ((c >> 32) & 0xFFFFFFFF).to(torch.float64)
    return hi * 4294967296.0 + (c & 0xFFFFFFFF).to(torch.float64)


def _float_to_int(x: torch.Tensor, to: Type) -> torch.Tensor:
    """nearbyint, NaN -> 0, saturating at the target's range (reference
    GB_casting.h GB_cast_to_int*).  In float64, where the bounds of
    32-bit targets are exact; INT64_MAX and UINT64_MAX are not (they
    round up to 2^63 and 2^64), so 64-bit targets saturate by compare."""
    x = x.to(torch.float64)
    r = torch.where(torch.isnan(x), torch.zeros_like(x), torch.round(x))
    info = np.iinfo(to.np_dtype)
    if info.bits <= 32:
        r = torch.clamp(r, float(info.min), float(info.max))
        if to.torch_dtype in _CARRIER:
            return uncarry(r.to(torch.int64), to.torch_dtype)
        return r.to(to.torch_dtype)
    if to.is_signed:
        hi, lo = r >= 2.0 ** 63, r <= -2.0 ** 63
        c = torch.where(hi | lo, torch.zeros_like(r), r).to(torch.int64)
        c = torch.where(hi, torch.full_like(c, info.max), c)
        return torch.where(lo, torch.full_like(c, info.min), c)
    # UINT64: above 2^63, r is a multiple of 2^11, so r - 2^63 is exact
    r = torch.clamp(r, min=0.0)
    hi, big = r >= 2.0 ** 64, r >= 2.0 ** 63
    low = torch.where(big, r - 2.0 ** 63, r)
    c = torch.where(hi, torch.zeros_like(r), low).to(torch.int64)
    c = torch.where(big, c ^ TOP, c)
    return torch.where(hi, torch.full_like(c, -1), c).view(torch.uint64)


def upcast_pair(a: Type, b: Type) -> Type:
    """Type of a op b under numpy promotion (the JAX package's rule, so
    both packages pick the same output type).  BF16 with a bool or an
    integer stays BF16, with a wider float or a complex widens to it, as
    ``ml_dtypes`` promotes."""
    if BF16 in (a, b):
        other = b if a == BF16 else a
        if other == BF16 or not (other.is_float or other.is_complex):
            return BF16
    return lookup(np.promote_types(a.np_dtype, b.np_dtype))
