"""GraphBLAS operators as torch callables (counterpart of
``graphblas_tpu.core.ops``; reference: Source/GB_ops.c).

An operator is a Python callable over tensors, polymorphic over dtype like
the reference's GrB_PLUS covering every GrB_PLUS_T; a fixed output type
(BOOL for comparators) is declared through ``ztype``.  Positional binary
ops (FIRSTI/FIRSTJ/SECONDI/SECONDJ and their +1 forms) carry a
``positional`` tag: kernels substitute entry coordinates for values.

Torch has almost no kernels for UINT16/UINT32/UINT64, so every op computes
on them through a signed carrier (``types.carry``): + - x wrap modulo 2^w,
order compares the carriers' ``order_key``, and UINT64 division is an
unsigned 64-bit division built from signed ones (``_udiv64``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from . import types as T


# ---------------------------------------------------------------------------
# operator classes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UnaryOp:
    """z = f(x)  (reference: GrB_UnaryOp)."""

    name: str
    fn: Callable[[Any], Any]
    ztype: Optional[T.Type] = None  # None => same as input
    positional: Optional[str] = None  # 'i' | 'i1' | 'j' | 'j1'

    def __call__(self, x):
        return self.fn(x)

    def out_type(self, xtype: T.Type) -> T.Type:
        return self.ztype or xtype

    def __repr__(self):
        return f"UnaryOp({self.name})"


@dataclasses.dataclass(frozen=True)
class BinaryOp:
    """z = f(x, y)  (reference: GrB_BinaryOp)."""

    name: str
    fn: Callable[[Any, Any], Any]
    ztype: Optional[T.Type] = None
    positional: Optional[str] = None  # 'firsti'|'firsti1'|'firstj'|...
    commutative: bool = False

    def __call__(self, x, y):
        return self.fn(x, y)

    def out_type(self, xtype: T.Type, ytype: T.Type | None = None) -> T.Type:
        if self.ztype is not None:
            return self.ztype
        if self.positional:
            return T.INT64
        if ytype is None or xtype == ytype:
            return xtype
        return T.upcast_pair(xtype, ytype)

    def flipped(self) -> "BinaryOp":
        """The op with arguments swapped (reference: GB_flip_binop,
        Source/GB_AxB_meta.c:453-468)."""
        if self.commutative:
            return self
        flip_pos = {"firsti": "secondi", "firsti1": "secondi1",
                    "firstj": "secondj", "firstj1": "secondj1",
                    "secondi": "firsti", "secondi1": "firsti1",
                    "secondj": "firstj", "secondj1": "firstj1"}
        f = self.fn
        return BinaryOp(self.name + "_flipped", lambda x, y: f(y, x),
                        ztype=self.ztype,
                        positional=flip_pos.get(self.positional),
                        commutative=False)

    def __repr__(self):
        return f"BinaryOp({self.name})"


@dataclasses.dataclass(frozen=True)
class IndexUnaryOp:
    """z = f(x, i, j, thunk)  (reference: GrB_IndexUnaryOp)."""

    name: str
    fn: Callable[[Any, Any, Any, Any], Any]
    ztype: Optional[T.Type] = None
    positional: bool = False
    value_only: bool = False

    def __call__(self, x, i, j, thunk):
        return self.fn(x, i, j, thunk)

    def out_type(self, xtype: T.Type) -> T.Type:
        return self.ztype or xtype

    def __repr__(self):
        return f"IndexUnaryOp({self.name})"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _tt(x, like):
    """Python scalars -> tensors on ``like``'s device (of like's dtype
    where that is unsigned: numpy promotion would widen it)."""
    if isinstance(x, torch.Tensor):
        return x
    if T.wide_unsigned(like.dtype):
        return T.scalar(x, T.lookup(like.dtype), like.device)
    return torch.as_tensor(x, device=like.device)


def _pair(x, y):
    if not isinstance(x, torch.Tensor):
        x = _tt(x, y)
    if not isinstance(y, torch.Tensor):
        y = _tt(y, x)
    return x, y


def _common(x, y):
    """(x, y) as tensors of one dtype: torch promotion, or numpy's where
    an unsigned dtype takes part (torch has no rule for them)."""
    x, y = _pair(x, y)
    if x.dtype != y.dtype and (T.wide_unsigned(x.dtype)
                               or T.wide_unsigned(y.dtype)):
        ty = T.upcast_pair(T.lookup(x.dtype), T.lookup(y.dtype))
        return T.cast(x, ty), T.cast(y, ty)
    return x, y


def _is_int(dt: torch.dtype) -> bool:
    return not dt.is_floating_point and not dt.is_complex \
        and dt != torch.bool


def _wrapping(fn):
    """+ - x: through the carrier, wrapped back to the type."""
    def f(x, y):
        x, y = _common(x, y)
        if not T.wide_unsigned(x.dtype):
            return fn(x, y)
        return T.uncarry(fn(T.carry(x), T.carry(y)), x.dtype)
    return f


def _ordered(fn):
    """A comparison, on the unsigned types through their order keys."""
    def f(x, y):
        x, y = _common(x, y)
        if T.wide_unsigned(x.dtype):
            dt = x.dtype
            return fn(T.order_key(T.carry(x), dt), T.order_key(T.carry(y), dt))
        return fn(x, y)
    return f


def _bitwise(fn):
    """A bitwise op, on the unsigned types through their signed views."""
    def f(x, y):
        x, y = _common(x, y)
        return T.unbits(fn(T.bits(x), T.bits(y)), x.dtype)
    return f


def _floating(fn):
    """A float-math op: unsigned inputs go to FP64 first."""
    def f(*args):
        return fn(*(T.cast(a, T.FP64) if isinstance(a, torch.Tensor)
                    and T.wide_unsigned(a.dtype) else a for a in args))
    return f


# The reference defines integer x/0 (GB_math.h GB_idiv_*): 0/0 = 0,
# x/0 = INT_MAX (x>0) or INT_MIN (x<0) for signed; UINT_MAX for unsigned.
# Floats follow IEEE.  C-style truncating division for ints.

def _int_div(x, y):
    x, y = _common(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
    if T.wide_unsigned(dt):
        return _udiv(x, y)
    if not _is_int(dt):
        return x / y
    x, y = x.to(dt), y.to(dt)
    safe = torch.where(y == 0, torch.ones_like(y), y)
    trunc = torch.div(x, safe, rounding_mode="trunc")
    info = torch.iinfo(dt)
    imax = torch.full_like(trunc, info.max)
    zero = torch.zeros_like(trunc)
    if info.min < 0:
        div0 = torch.where(x == 0, zero,
                           torch.where(x > 0, imax,
                                       torch.full_like(trunc, info.min)))
    else:
        div0 = torch.where(x == 0, zero, imax)
    return torch.where(y == 0, div0, trunc)


def _udiv(x, y):
    """Unsigned x / y on the carriers; x / 0 = UINT_MAX, 0 / 0 = 0."""
    dt = x.dtype
    cx, cy = torch.broadcast_tensors(T.carry(x), T.carry(y))
    if dt == torch.uint64:
        q = _udiv64(cx, cy)
    else:
        q = torch.div(cx, torch.where(cy == 0, torch.ones_like(cy), cy),
                      rounding_mode="trunc")
    umax = torch.full_like(q, -1 if dt == torch.uint64
                           else int(np.iinfo(T.lookup(dt).np_dtype).max))
    div0 = torch.where(cx == 0, torch.zeros_like(q), umax)
    return T.uncarry(torch.where(cy == 0, div0, q), dt)


def _udiv64(x, y):
    """Quotient of the unsigned 64-bit values whose bit patterns the int64
    tensors x, y hold (y != 0).  A divisor >= 2^63 gives 0 or 1; else
    divide x >> 1 (logical) by y, double, and correct by one."""
    big = y < 0
    ys = torch.where(big | (y == 0), torch.ones_like(y), y)
    q = torch.div((x >> 1) & 0x7FFFFFFFFFFFFFFF, ys,
                  rounding_mode="trunc") << 1
    r = x - q * ys                      # in [0, 2 ys): no wrap past 2^64
    q = q + ((r ^ T.TOP) >= (ys ^ T.TOP)).to(torch.int64)
    return torch.where(big, ((x ^ T.TOP) >= (y ^ T.TOP)).to(torch.int64), q)


def _upow(x, y):
    """x ** y on the unsigned carriers, by squaring over the exponent's w
    bits (wraps modulo 2^w, as the reference's integer pow)."""
    dt = x.dtype
    nb = torch.iinfo(dt).bits
    b, e = torch.broadcast_tensors(T.carry(x), T.carry(y))
    r = torch.ones_like(b)
    for _ in range(nb):
        r = torch.where((e & 1) == 1, r * b, r)
        b = b * b
        e = (e >> 1) & 0x7FFFFFFFFFFFFFFF
    return T.uncarry(r, dt)


def _pow(x, y):
    x, y = _common(x, y)
    return _upow(x, y) if T.wide_unsigned(x.dtype) else torch.pow(x, y)


def _minmax(kind):
    # GraphBLAS MIN/MAX are "omitnan" (reference: GB_math.h fmin/fmax):
    # NaN loses against any number.
    def f(x, y):
        x, y = _common(x, y)
        if x.is_floating_point() or y.is_floating_point():
            return torch.fmin(x, y) if kind == "min" else torch.fmax(x, y)
        if T.wide_unsigned(x.dtype):
            dt = x.dtype
            cx, cy = T.carry(x), T.carry(y)
            kx, ky = T.order_key(cx, dt), T.order_key(cy, dt)
            pick = kx <= ky if kind == "min" else kx >= ky
            return T.uncarry(torch.where(pick, cx, cy), dt)
        return torch.minimum(x, y) if kind == "min" else torch.maximum(x, y)
    return f


def _signum(x):
    if x.dtype == torch.bool:
        return x
    if T.wide_unsigned(x.dtype):
        return (T.bits(x) != 0).to(x.dtype)
    if x.is_floating_point():      # sign(NaN) is NaN (torch.sign gives 0)
        return torch.where(torch.isnan(x), x, torch.sign(x))
    return torch.sign(x)


def _bshift(x, s):
    # reference GB_bitshift_*: shift left if s>0, arithmetic right if s<0;
    # |s| >= nbits gives 0 (or sign-fill for right shift of signed).
    x, s = _pair(x, s)
    dt = x.dtype
    nbits = torch.iinfo(dt).bits
    c = T.carry(x)
    s = s.to(torch.int64)
    ls = torch.clamp(s, 0, nbits)
    rs = torch.clamp(-s, 0, nbits)
    left = torch.where(ls >= nbits, torch.zeros_like(c),
                       c << torch.clamp(ls, max=nbits - 1).to(c.dtype))
    sh = torch.clamp(rs, max=nbits - 1).to(c.dtype)
    if torch.iinfo(dt).min < 0:
        rshift = c >> sh
    else:
        rshift = c >> sh
        if dt == torch.uint64:        # logical: clear the sign fill
            rshift = torch.where(sh == 0, c, rshift & ((1 << (64 - sh)) - 1))
        rshift = torch.where(rs >= nbits, torch.zeros_like(c), rshift)
    out = torch.where(s >= 0, left, rshift)
    return T.uncarry(out, dt) if T.wide_unsigned(dt) else out


def _as_in(fn):
    def f(x, y):
        x, y = _common(x, y)
        return T.cast(_ordered(fn)(x, y), T.lookup(x.dtype))
    return f


def _boolop(fn):
    # boolean ops applied in the input type's domain (reference semantics
    # for LOR over non-bool types)
    def f(x, y):
        x, y = _common(x, y)
        return T.cast(fn(T.bits(x) != 0, T.bits(y) != 0),
                      T.lookup(x.dtype))
    return f


def _cmplx(x, y):
    x, y = _pair(x, y)
    return torch.complex(T.cast(x, T.FP64), T.cast(y, T.FP64))


def _shift_arg(y, x):
    """The bit position of BGET/BSET/BCLR in x's signed view dtype."""
    return _tt(y, x).to(T.bits(x).dtype)


def _bget(x, y):
    xb = T.bits(x)
    return T.unbits((xb >> _shift_arg(y, x)) & 1, x.dtype)


def _bset(x, y):
    xb = T.bits(x)
    return T.unbits(xb | (torch.ones_like(xb) << _shift_arg(y, x)),
                    x.dtype)


def _bclr(x, y):
    xb = T.bits(x)
    return T.unbits(xb & ~(torch.ones_like(xb) << _shift_arg(y, x)),
                    x.dtype)


# ---------------------------------------------------------------------------
# built-in binary ops (reference: Source/GB_ops.c, Include/GraphBLAS.h)
# ---------------------------------------------------------------------------

FIRST = BinaryOp("GrB_FIRST", lambda x, y: x)
SECOND = BinaryOp("GrB_SECOND", lambda x, y: y)
ONEB = BinaryOp("GrB_ONEB", lambda x, y: torch.ones_like(x),
                commutative=True)
PAIR = ONEB  # GxB_PAIR is the historical name for GrB_ONEB
ANY = BinaryOp("GxB_ANY", lambda x, y: y, commutative=True)
PLUS = BinaryOp("GrB_PLUS", _wrapping(torch.add), commutative=True)
MINUS = BinaryOp("GrB_MINUS", _wrapping(torch.sub))
RMINUS = BinaryOp("GxB_RMINUS", _wrapping(lambda x, y: torch.sub(y, x)))
TIMES = BinaryOp("GrB_TIMES", _wrapping(torch.mul), commutative=True)
DIV = BinaryOp("GrB_DIV", _int_div)
RDIV = BinaryOp("GxB_RDIV", lambda x, y: _int_div(y, x))
MIN = BinaryOp("GrB_MIN", _minmax("min"), commutative=True)
MAX = BinaryOp("GrB_MAX", _minmax("max"), commutative=True)
POW = BinaryOp("GxB_POW", _pow)

# comparators, bool result (GrB_EQ/NE/GT/LT/GE/LE)
EQ = BinaryOp("GrB_EQ", _ordered(torch.eq), ztype=T.BOOL, commutative=True)
NE = BinaryOp("GrB_NE", _ordered(torch.ne), ztype=T.BOOL, commutative=True)
GT = BinaryOp("GrB_GT", _ordered(torch.gt), ztype=T.BOOL)
LT = BinaryOp("GrB_LT", _ordered(torch.lt), ztype=T.BOOL)
GE = BinaryOp("GrB_GE", _ordered(torch.ge), ztype=T.BOOL)
LE = BinaryOp("GrB_LE", _ordered(torch.le), ztype=T.BOOL)

# "IS" comparators, same-type result (GxB_ISEQ etc.)
ISEQ = BinaryOp("GxB_ISEQ", _as_in(torch.eq), commutative=True)
ISNE = BinaryOp("GxB_ISNE", _as_in(torch.ne), commutative=True)
ISGT = BinaryOp("GxB_ISGT", _as_in(torch.gt))
ISLT = BinaryOp("GxB_ISLT", _as_in(torch.lt))
ISGE = BinaryOp("GxB_ISGE", _as_in(torch.ge))
ISLE = BinaryOp("GxB_ISLE", _as_in(torch.le))

LOR = BinaryOp("GrB_LOR", _boolop(torch.logical_or), commutative=True)
LAND = BinaryOp("GrB_LAND", _boolop(torch.logical_and), commutative=True)
LXOR = BinaryOp("GrB_LXOR", _boolop(torch.logical_xor), commutative=True)
LXNOR = BinaryOp("GrB_LXNOR", _boolop(lambda a, b: a == b),
                 commutative=True)

# bitwise (integers only)
BOR = BinaryOp("GrB_BOR", _bitwise(lambda x, y: x | y), commutative=True)
BAND = BinaryOp("GrB_BAND", _bitwise(lambda x, y: x & y), commutative=True)
BXOR = BinaryOp("GrB_BXOR", _bitwise(lambda x, y: x ^ y), commutative=True)
BXNOR = BinaryOp("GrB_BXNOR", _bitwise(lambda x, y: ~(x ^ y)),
                 commutative=True)
BGET = BinaryOp("GxB_BGET", _bget)
BSET = BinaryOp("GxB_BSET", _bset)
BCLR = BinaryOp("GxB_BCLR", _bclr)
BSHIFT = BinaryOp("GxB_BSHIFT", _bshift)

# float-math binaries
ATAN2 = BinaryOp("GxB_ATAN2",
                 _floating(lambda x, y: torch.atan2(*_pair(x, y))))
HYPOT = BinaryOp("GxB_HYPOT",
                 _floating(lambda x, y: torch.hypot(*_pair(x, y))),
                 commutative=True)
FMOD = BinaryOp("GxB_FMOD",
                 _floating(lambda x, y: torch.fmod(*_pair(x, y))))
REMAINDER = BinaryOp("GxB_REMAINDER",
                     _floating(lambda x, y: x - y * torch.round(x / y)))
LDEXP = BinaryOp("GxB_LDEXP", _floating(
    lambda x, y: x * torch.exp2(_tt(y, x).to(x.dtype))))
COPYSIGN = BinaryOp("GxB_COPYSIGN",
                    _floating(lambda x, y: torch.copysign(*_pair(x, y))))
CMPLX = BinaryOp("GxB_CMPLX", _cmplx, ztype=T.FC64)

# positional multiply ops (reference: GxB_FIRSTI_INT64 family) — kernels
# substitute coordinates; fn here receives the already-substituted values.
FIRSTI = BinaryOp("GxB_FIRSTI", lambda x, y: x, positional="firsti")
FIRSTI1 = BinaryOp("GxB_FIRSTI1", lambda x, y: x + 1, positional="firsti1")
FIRSTJ = BinaryOp("GxB_FIRSTJ", lambda x, y: x, positional="firstj")
FIRSTJ1 = BinaryOp("GxB_FIRSTJ1", lambda x, y: x + 1, positional="firstj1")
SECONDI = BinaryOp("GxB_SECONDI", lambda x, y: y, positional="secondi")
SECONDI1 = BinaryOp("GxB_SECONDI1", lambda x, y: y + 1,
                    positional="secondi1")
SECONDJ = BinaryOp("GxB_SECONDJ", lambda x, y: y, positional="secondj")
SECONDJ1 = BinaryOp("GxB_SECONDJ1", lambda x, y: y + 1,
                    positional="secondj1")


# ---------------------------------------------------------------------------
# built-in unary ops
# ---------------------------------------------------------------------------

def _ainv(x):
    if T.wide_unsigned(x.dtype):
        return T.uncarry(-T.carry(x), x.dtype)
    return x if x.dtype == torch.bool else torch.neg(x)


def _abs(x):
    return x if T.wide_unsigned(x.dtype) else torch.abs(x)


def _integral(fn):
    """CEIL/FLOOR/ROUND/TRUNC: integers are their own value."""
    def f(x):
        return x if T.wide_unsigned(x.dtype) else fn(x)
    return f


def _frexpx(x):
    return torch.frexp(x)[0]


def _frexpe(x):
    return torch.frexp(x)[1].to(x.dtype)


IDENTITY = UnaryOp("GrB_IDENTITY", lambda x: x)
AINV = UnaryOp("GrB_AINV", _ainv)
ONE = UnaryOp("GxB_ONE", torch.ones_like)
ABS = UnaryOp("GrB_ABS", _abs)
MINV = UnaryOp("GrB_MINV", lambda x: _int_div(torch.ones_like(x), x))
LNOT = UnaryOp("GrB_LNOT",
               lambda x: T.cast(T.bits(x) == 0, T.lookup(x.dtype)))
BNOT = UnaryOp("GrB_BNOT", lambda x: T.unbits(~T.bits(x), x.dtype))

SQRT = UnaryOp("GxB_SQRT", _floating(torch.sqrt))
LOG = UnaryOp("GxB_LOG", _floating(torch.log))
EXP = UnaryOp("GxB_EXP", _floating(torch.exp))
LOG2 = UnaryOp("GxB_LOG2", _floating(torch.log2))
LOG10 = UnaryOp("GxB_LOG10", _floating(torch.log10))
LOG1P = UnaryOp("GxB_LOG1P", _floating(torch.log1p))
EXP2 = UnaryOp("GxB_EXP2", _floating(torch.exp2))
EXPM1 = UnaryOp("GxB_EXPM1", _floating(torch.expm1))
SIN = UnaryOp("GxB_SIN", _floating(torch.sin))
COS = UnaryOp("GxB_COS", _floating(torch.cos))
TAN = UnaryOp("GxB_TAN", _floating(torch.tan))
ASIN = UnaryOp("GxB_ASIN", _floating(torch.asin))
ACOS = UnaryOp("GxB_ACOS", _floating(torch.acos))
ATAN = UnaryOp("GxB_ATAN", _floating(torch.atan))
SINH = UnaryOp("GxB_SINH", _floating(torch.sinh))
COSH = UnaryOp("GxB_COSH", _floating(torch.cosh))
TANH = UnaryOp("GxB_TANH", _floating(torch.tanh))
ASINH = UnaryOp("GxB_ASINH", _floating(torch.asinh))
ACOSH = UnaryOp("GxB_ACOSH", _floating(torch.acosh))
ATANH = UnaryOp("GxB_ATANH", _floating(torch.atanh))
SIGNUM = UnaryOp("GxB_SIGNUM", _signum)
CEIL = UnaryOp("GxB_CEIL", _integral(torch.ceil))
FLOOR = UnaryOp("GxB_FLOOR", _integral(torch.floor))
ROUND = UnaryOp("GxB_ROUND", _integral(torch.round))
TRUNC = UnaryOp("GxB_TRUNC", _integral(torch.trunc))
CBRT = UnaryOp("GxB_CBRT",
               _floating(lambda x: torch.sign(x) * torch.abs(x)
                         ** (1.0 / 3.0)))
LGAMMA = UnaryOp("GxB_LGAMMA", _floating(torch.lgamma))
TGAMMA = UnaryOp("GxB_TGAMMA",
                 _floating(lambda x: torch.exp(torch.lgamma(x))))
ERF = UnaryOp("GxB_ERF", _floating(torch.special.erf))
ERFC = UnaryOp("GxB_ERFC", _floating(torch.special.erfc))
FREXPX = UnaryOp("GxB_FREXPX", _floating(_frexpx))
FREXPE = UnaryOp("GxB_FREXPE", _floating(_frexpe))

CONJ = UnaryOp("GxB_CONJ", torch.conj)
CREAL = UnaryOp("GxB_CREAL", torch.real, ztype=T.FP64)
CIMAG = UnaryOp("GxB_CIMAG",
                lambda x: torch.imag(x) if x.is_complex()
                else torch.zeros_like(x), ztype=T.FP64)
CARG = UnaryOp("GxB_CARG", _floating(torch.angle), ztype=T.FP64)
ISINF = UnaryOp("GxB_ISINF", _floating(torch.isinf), ztype=T.BOOL)
ISNAN = UnaryOp("GxB_ISNAN", _floating(torch.isnan), ztype=T.BOOL)
ISFINITE = UnaryOp("GxB_ISFINITE", _floating(torch.isfinite), ztype=T.BOOL)

POSITIONI = UnaryOp("GxB_POSITIONI", lambda i: i, ztype=T.INT64,
                    positional="i")
POSITIONI1 = UnaryOp("GxB_POSITIONI1", lambda i: i + 1, ztype=T.INT64,
                     positional="i1")
POSITIONJ = UnaryOp("GxB_POSITIONJ", lambda j: j, ztype=T.INT64,
                    positional="j")
POSITIONJ1 = UnaryOp("GxB_POSITIONJ1", lambda j: j + 1, ztype=T.INT64,
                     positional="j1")


# ---------------------------------------------------------------------------
# built-in index-unary ops (reference: GrB_IndexUnaryOp list)
# ---------------------------------------------------------------------------

ROWINDEX = IndexUnaryOp("GrB_ROWINDEX", lambda x, i, j, k: i + k,
                        ztype=T.INT64, positional=True)
COLINDEX = IndexUnaryOp("GrB_COLINDEX", lambda x, i, j, k: j + k,
                        ztype=T.INT64, positional=True)
DIAGINDEX = IndexUnaryOp("GrB_DIAGINDEX", lambda x, i, j, k: j - i + k,
                         ztype=T.INT64, positional=True)
TRIL = IndexUnaryOp("GrB_TRIL", lambda x, i, j, k: j <= i + k,
                    ztype=T.BOOL, positional=True)
TRIU = IndexUnaryOp("GrB_TRIU", lambda x, i, j, k: j >= i + k,
                    ztype=T.BOOL, positional=True)
DIAG = IndexUnaryOp("GrB_DIAG", lambda x, i, j, k: j == i + k,
                    ztype=T.BOOL, positional=True)
OFFDIAG = IndexUnaryOp("GrB_OFFDIAG", lambda x, i, j, k: j != i + k,
                       ztype=T.BOOL, positional=True)
COLLE = IndexUnaryOp("GrB_COLLE", lambda x, i, j, k: j <= k,
                     ztype=T.BOOL, positional=True)
COLGT = IndexUnaryOp("GrB_COLGT", lambda x, i, j, k: j > k,
                     ztype=T.BOOL, positional=True)
ROWLE = IndexUnaryOp("GrB_ROWLE", lambda x, i, j, k: i <= k,
                     ztype=T.BOOL, positional=True)
ROWGT = IndexUnaryOp("GrB_ROWGT", lambda x, i, j, k: i > k,
                     ztype=T.BOOL, positional=True)
VALUENE = IndexUnaryOp("GrB_VALUENE", lambda x, i, j, k: NE.fn(x, k),
                       ztype=T.BOOL, value_only=True)
VALUEEQ = IndexUnaryOp("GrB_VALUEEQ", lambda x, i, j, k: EQ.fn(x, k),
                       ztype=T.BOOL, value_only=True)
VALUEGT = IndexUnaryOp("GrB_VALUEGT", lambda x, i, j, k: GT.fn(x, k),
                       ztype=T.BOOL, value_only=True)
VALUEGE = IndexUnaryOp("GrB_VALUEGE", lambda x, i, j, k: GE.fn(x, k),
                       ztype=T.BOOL, value_only=True)
VALUELT = IndexUnaryOp("GrB_VALUELT", lambda x, i, j, k: LT.fn(x, k),
                       ztype=T.BOOL, value_only=True)
VALUELE = IndexUnaryOp("GrB_VALUELE", lambda x, i, j, k: LE.fn(x, k),
                       ztype=T.BOOL, value_only=True)


def unary_op(fn, name="user_unary", ztype=None) -> UnaryOp:
    """User-defined unary op (reference: GrB_UnaryOp_new)."""
    return UnaryOp(name, fn, ztype=T.lookup(ztype) if ztype else None)


def binary_op(fn, name="user_binary", ztype=None,
              commutative=False) -> BinaryOp:
    """User-defined binary op (reference: GrB_BinaryOp_new)."""
    return BinaryOp(name, fn, ztype=T.lookup(ztype) if ztype else None,
                    commutative=commutative)


def index_unary_op(fn, name="user_idxunop", ztype=None) -> IndexUnaryOp:
    """User-defined index-unary op (reference: GrB_IndexUnaryOp_new)."""
    return IndexUnaryOp(name, fn, ztype=T.lookup(ztype) if ztype else None)
