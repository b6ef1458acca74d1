"""GraphBLAS operators as torch callables (counterpart of
``graphblas_tpu.core.ops``; reference: Source/GB_ops.c).

An operator is a Python callable over tensors, polymorphic over dtype like
the reference's GrB_PLUS covering every GrB_PLUS_T; a fixed output type
(BOOL for comparators) is declared through ``ztype``.  Positional binary
ops (FIRSTI/FIRSTJ/SECONDI/SECONDJ and their +1 forms) carry a
``positional`` tag: kernels substitute entry coordinates for values.

Arithmetic on UINT16/UINT32/UINT64 tensors raises ``NotImplementedError``:
torch on the CPU has no add, min or divide for them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

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
        if ytype is None or xtype is ytype:
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

def _arith(fn):
    """Refuse arithmetic on the unsigned types torch cannot compute."""
    @functools.wraps(fn)
    def f(*args):
        for a in args:
            if isinstance(a, torch.Tensor) and a.dtype in T.UNSIGNED_WIDE:
                raise NotImplementedError(
                    f"arithmetic on {a.dtype} is not supported yet "
                    "(torch has no kernels for it; see ROADMAP)")
        return fn(*args)
    return f


def _tt(x, like):
    """Python scalars -> tensors on ``like``'s device."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=like.device)


def _pair(x, y):
    if not isinstance(x, torch.Tensor):
        x = _tt(x, y)
    if not isinstance(y, torch.Tensor):
        y = _tt(y, x)
    return x, y


def _is_int(dt: torch.dtype) -> bool:
    return not dt.is_floating_point and not dt.is_complex \
        and dt != torch.bool


# The reference defines integer x/0 (GB_math.h GB_idiv_*): 0/0 = 0,
# x/0 = INT_MAX (x>0) or INT_MIN (x<0) for signed; UINT_MAX for unsigned.
# Floats follow IEEE.  C-style truncating division for ints.

def _int_div(x, y):
    x, y = _pair(x, y)
    dt = torch.promote_types(x.dtype, y.dtype)
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


def _minmax(kind):
    # GraphBLAS MIN/MAX are "omitnan" (reference: GB_math.h fmin/fmax):
    # NaN loses against any number.
    def f(x, y):
        x, y = _pair(x, y)
        if x.is_floating_point() or y.is_floating_point():
            return torch.fmin(x, y) if kind == "min" else torch.fmax(x, y)
        return torch.minimum(x, y) if kind == "min" else torch.maximum(x, y)
    return f


def _signum(x):
    if x.dtype == torch.bool:
        return x
    if x.is_floating_point():      # sign(NaN) is NaN (torch.sign gives 0)
        return torch.where(torch.isnan(x), x, torch.sign(x))
    return torch.sign(x)


def _bshift(x, s):
    # reference GB_bitshift_*: shift left if s>0, arithmetic right if s<0;
    # |s| >= nbits gives 0 (or sign-fill for right shift of signed).
    x, s = _pair(x, s)
    nbits = torch.iinfo(x.dtype).bits
    s = s.to(torch.int64)
    ls = torch.clamp(s, 0, nbits)
    rs = torch.clamp(-s, 0, nbits)
    left = torch.where(ls >= nbits, torch.zeros_like(x),
                       x << torch.clamp(ls, max=nbits - 1).to(x.dtype))
    if torch.iinfo(x.dtype).min < 0:
        rshift = x >> torch.clamp(rs, max=nbits - 1).to(x.dtype)
    else:
        rshift = torch.where(rs >= nbits, torch.zeros_like(x),
                             x >> torch.clamp(rs, max=nbits - 1).to(x.dtype))
    return torch.where(s >= 0, left, rshift)


def _as_in(fn):
    def f(x, y):
        x, y = _pair(x, y)
        return fn(x, y).to(torch.promote_types(x.dtype, y.dtype))
    return f


def _boolop(fn):
    # boolean ops applied in the input type's domain (reference semantics
    # for LOR over non-bool types)
    def f(x, y):
        x, y = _pair(x, y)
        return fn(x != 0, y != 0).to(torch.promote_types(x.dtype, y.dtype))
    return f


def _cmplx(x, y):
    x, y = _pair(x, y)
    return torch.complex(x.to(torch.float64), y.to(torch.float64))


# ---------------------------------------------------------------------------
# built-in binary ops (reference: Source/GB_ops.c, Include/GraphBLAS.h)
# ---------------------------------------------------------------------------

FIRST = BinaryOp("GrB_FIRST", lambda x, y: x)
SECOND = BinaryOp("GrB_SECOND", lambda x, y: y)
ONEB = BinaryOp("GrB_ONEB", lambda x, y: torch.ones_like(x),
                commutative=True)
PAIR = ONEB  # GxB_PAIR is the historical name for GrB_ONEB
ANY = BinaryOp("GxB_ANY", lambda x, y: y, commutative=True)
PLUS = BinaryOp("GrB_PLUS", _arith(lambda x, y: torch.add(*_pair(x, y))),
                commutative=True)
MINUS = BinaryOp("GrB_MINUS", _arith(lambda x, y: torch.sub(*_pair(x, y))))
RMINUS = BinaryOp("GxB_RMINUS",
                  _arith(lambda x, y: torch.sub(*_pair(y, x))))
TIMES = BinaryOp("GrB_TIMES", _arith(lambda x, y: torch.mul(*_pair(x, y))),
                 commutative=True)
DIV = BinaryOp("GrB_DIV", _arith(_int_div))
RDIV = BinaryOp("GxB_RDIV", _arith(lambda x, y: _int_div(y, x)))
MIN = BinaryOp("GrB_MIN", _arith(_minmax("min")), commutative=True)
MAX = BinaryOp("GrB_MAX", _arith(_minmax("max")), commutative=True)
POW = BinaryOp("GxB_POW", _arith(lambda x, y: torch.pow(*_pair(x, y))))

# comparators, bool result (GrB_EQ/NE/GT/LT/GE/LE)
EQ = BinaryOp("GrB_EQ", lambda x, y: x == y, ztype=T.BOOL, commutative=True)
NE = BinaryOp("GrB_NE", lambda x, y: x != y, ztype=T.BOOL, commutative=True)
GT = BinaryOp("GrB_GT", lambda x, y: x > y, ztype=T.BOOL)
LT = BinaryOp("GrB_LT", lambda x, y: x < y, ztype=T.BOOL)
GE = BinaryOp("GrB_GE", lambda x, y: x >= y, ztype=T.BOOL)
LE = BinaryOp("GrB_LE", lambda x, y: x <= y, ztype=T.BOOL)

# "IS" comparators, same-type result (GxB_ISEQ etc.)
ISEQ = BinaryOp("GxB_ISEQ", _as_in(lambda x, y: x == y), commutative=True)
ISNE = BinaryOp("GxB_ISNE", _as_in(lambda x, y: x != y), commutative=True)
ISGT = BinaryOp("GxB_ISGT", _as_in(lambda x, y: x > y))
ISLT = BinaryOp("GxB_ISLT", _as_in(lambda x, y: x < y))
ISGE = BinaryOp("GxB_ISGE", _as_in(lambda x, y: x >= y))
ISLE = BinaryOp("GxB_ISLE", _as_in(lambda x, y: x <= y))

LOR = BinaryOp("GrB_LOR", _boolop(torch.logical_or), commutative=True)
LAND = BinaryOp("GrB_LAND", _boolop(torch.logical_and), commutative=True)
LXOR = BinaryOp("GrB_LXOR", _boolop(torch.logical_xor), commutative=True)
LXNOR = BinaryOp("GrB_LXNOR", _boolop(lambda a, b: a == b),
                 commutative=True)

# bitwise (integers only)
BOR = BinaryOp("GrB_BOR", lambda x, y: x | y, commutative=True)
BAND = BinaryOp("GrB_BAND", lambda x, y: x & y, commutative=True)
BXOR = BinaryOp("GrB_BXOR", lambda x, y: x ^ y, commutative=True)
BXNOR = BinaryOp("GrB_BXNOR", lambda x, y: ~(x ^ y), commutative=True)
BGET = BinaryOp("GxB_BGET", lambda x, y: (x >> _tt(y, x).to(x.dtype)) & 1)
BSET = BinaryOp("GxB_BSET",
                lambda x, y: x | (torch.ones_like(x) << _tt(y, x).to(x.dtype)))
BCLR = BinaryOp("GxB_BCLR",
                lambda x, y: x & ~(torch.ones_like(x)
                                   << _tt(y, x).to(x.dtype)))
BSHIFT = BinaryOp("GxB_BSHIFT", _bshift)

# float-math binaries
ATAN2 = BinaryOp("GxB_ATAN2", _arith(lambda x, y: torch.atan2(*_pair(x, y))))
HYPOT = BinaryOp("GxB_HYPOT", _arith(lambda x, y: torch.hypot(*_pair(x, y))),
                 commutative=True)
FMOD = BinaryOp("GxB_FMOD", _arith(lambda x, y: torch.fmod(*_pair(x, y))))
REMAINDER = BinaryOp("GxB_REMAINDER",
                     _arith(lambda x, y: x - y * torch.round(x / y)))
LDEXP = BinaryOp("GxB_LDEXP",
                 _arith(lambda x, y: x * torch.exp2(_tt(y, x).to(x.dtype))))
COPYSIGN = BinaryOp("GxB_COPYSIGN",
                    _arith(lambda x, y: torch.copysign(*_pair(x, y))))
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
    return x if x.dtype == torch.bool else torch.neg(x)


def _frexpx(x):
    return torch.frexp(x)[0]


def _frexpe(x):
    return torch.frexp(x)[1].to(x.dtype)


IDENTITY = UnaryOp("GrB_IDENTITY", lambda x: x)
AINV = UnaryOp("GrB_AINV", _arith(_ainv))
ONE = UnaryOp("GxB_ONE", torch.ones_like)
ABS = UnaryOp("GrB_ABS", _arith(torch.abs))
MINV = UnaryOp("GrB_MINV", _arith(lambda x: _int_div(torch.ones_like(x), x)))
LNOT = UnaryOp("GrB_LNOT", lambda x: (x == 0).to(x.dtype))
BNOT = UnaryOp("GrB_BNOT", lambda x: ~x)

SQRT = UnaryOp("GxB_SQRT", _arith(torch.sqrt))
LOG = UnaryOp("GxB_LOG", _arith(torch.log))
EXP = UnaryOp("GxB_EXP", _arith(torch.exp))
LOG2 = UnaryOp("GxB_LOG2", _arith(torch.log2))
LOG10 = UnaryOp("GxB_LOG10", _arith(torch.log10))
LOG1P = UnaryOp("GxB_LOG1P", _arith(torch.log1p))
EXP2 = UnaryOp("GxB_EXP2", _arith(torch.exp2))
EXPM1 = UnaryOp("GxB_EXPM1", _arith(torch.expm1))
SIN = UnaryOp("GxB_SIN", _arith(torch.sin))
COS = UnaryOp("GxB_COS", _arith(torch.cos))
TAN = UnaryOp("GxB_TAN", _arith(torch.tan))
ASIN = UnaryOp("GxB_ASIN", _arith(torch.asin))
ACOS = UnaryOp("GxB_ACOS", _arith(torch.acos))
ATAN = UnaryOp("GxB_ATAN", _arith(torch.atan))
SINH = UnaryOp("GxB_SINH", _arith(torch.sinh))
COSH = UnaryOp("GxB_COSH", _arith(torch.cosh))
TANH = UnaryOp("GxB_TANH", _arith(torch.tanh))
ASINH = UnaryOp("GxB_ASINH", _arith(torch.asinh))
ACOSH = UnaryOp("GxB_ACOSH", _arith(torch.acosh))
ATANH = UnaryOp("GxB_ATANH", _arith(torch.atanh))
SIGNUM = UnaryOp("GxB_SIGNUM", _arith(_signum))
CEIL = UnaryOp("GxB_CEIL", _arith(torch.ceil))
FLOOR = UnaryOp("GxB_FLOOR", _arith(torch.floor))
ROUND = UnaryOp("GxB_ROUND", _arith(torch.round))
TRUNC = UnaryOp("GxB_TRUNC", _arith(torch.trunc))
CBRT = UnaryOp("GxB_CBRT",
               _arith(lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)))
LGAMMA = UnaryOp("GxB_LGAMMA", _arith(torch.lgamma))
TGAMMA = UnaryOp("GxB_TGAMMA", _arith(lambda x: torch.exp(torch.lgamma(x))))
ERF = UnaryOp("GxB_ERF", _arith(torch.special.erf))
ERFC = UnaryOp("GxB_ERFC", _arith(torch.special.erfc))
FREXPX = UnaryOp("GxB_FREXPX", _arith(_frexpx))
FREXPE = UnaryOp("GxB_FREXPE", _arith(_frexpe))

CONJ = UnaryOp("GxB_CONJ", torch.conj)
CREAL = UnaryOp("GxB_CREAL", torch.real, ztype=T.FP64)
CIMAG = UnaryOp("GxB_CIMAG",
                lambda x: torch.imag(x) if x.is_complex()
                else torch.zeros_like(x), ztype=T.FP64)
CARG = UnaryOp("GxB_CARG", torch.angle, ztype=T.FP64)
ISINF = UnaryOp("GxB_ISINF", torch.isinf, ztype=T.BOOL)
ISNAN = UnaryOp("GxB_ISNAN", torch.isnan, ztype=T.BOOL)
ISFINITE = UnaryOp("GxB_ISFINITE", torch.isfinite, ztype=T.BOOL)

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
VALUENE = IndexUnaryOp("GrB_VALUENE", lambda x, i, j, k: x != k,
                       ztype=T.BOOL, value_only=True)
VALUEEQ = IndexUnaryOp("GrB_VALUEEQ", lambda x, i, j, k: x == k,
                       ztype=T.BOOL, value_only=True)
VALUEGT = IndexUnaryOp("GrB_VALUEGT", lambda x, i, j, k: x > k,
                       ztype=T.BOOL, value_only=True)
VALUEGE = IndexUnaryOp("GrB_VALUEGE", lambda x, i, j, k: x >= k,
                       ztype=T.BOOL, value_only=True)
VALUELT = IndexUnaryOp("GrB_VALUELT", lambda x, i, j, k: x < k,
                       ztype=T.BOOL, value_only=True)
VALUELE = IndexUnaryOp("GrB_VALUELE", lambda x, i, j, k: x <= k,
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
