"""Named built-in algebra registry (the port's copy of
``graphblas_tpu.core.names``).

The reference predefines, as C symbols, 13 types, ~80 unary ops, 300+
typed binary ops, index-unary ops, 77 monoids, and exactly **1553
semirings** (reference: Include/GraphBLAS.h:8252-8345 — the breakdown is
1000 TxT->T + 300 comparator + 55 boolean + 54 complex + 64 bitwise + 80
positional).  Here operators are dtype-polymorphic traced callables, so the
typed variants are *views*: (polymorphic op, declared type).  This module
materializes every reference name lazily and resolves it with ``lookup``;
module attribute access also works (``names.GxB_MIN_PLUS_FP32``).

Counting identities mirror the reference exactly, including the remapped
duplicates it still names (min_pair == any_pair etc., GraphBLAS.h:8268-8271).
"""

from __future__ import annotations

import dataclasses

import torch

from . import monoid as M
from . import ops as OPS
from . import types as T
from .monoid import Monoid
from .ops import BinaryOp, IndexUnaryOp, UnaryOp
from .semiring import Semiring

# ---------------------------------------------------------------------------
# type tables
# ---------------------------------------------------------------------------

TYPE_BY_SUFFIX = {
    "BOOL": T.BOOL, "INT8": T.INT8, "INT16": T.INT16, "INT32": T.INT32,
    "INT64": T.INT64, "UINT8": T.UINT8, "UINT16": T.UINT16,
    "UINT32": T.UINT32, "UINT64": T.UINT64, "FP32": T.FP32, "FP64": T.FP64,
    "FC32": T.FC32, "FC64": T.FC64,
}
REAL10 = ("INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32",
          "UINT64", "FP32", "FP64")       # non-bool, non-complex
INT8T = ("INT8", "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32",
         "UINT64")
UINT4 = ("UINT8", "UINT16", "UINT32", "UINT64")
FP2 = ("FP32", "FP64")
FC2 = ("FC32", "FC64")
ALL13 = ("BOOL",) + REAL10 + FC2

# ---------------------------------------------------------------------------
# op tables (GraphBLAS.h:8258-8317)
# ---------------------------------------------------------------------------

_MULT_BY_NAME = {
    "FIRST": OPS.FIRST, "SECOND": OPS.SECOND, "PAIR": OPS.ONEB,
    "ONEB": OPS.ONEB, "ANY": OPS.ANY, "MIN": OPS.MIN, "MAX": OPS.MAX,
    "PLUS": OPS.PLUS, "MINUS": OPS.MINUS, "RMINUS": OPS.RMINUS,
    "TIMES": OPS.TIMES, "DIV": OPS.DIV, "RDIV": OPS.RDIV,
    "ISEQ": OPS.ISEQ, "ISNE": OPS.ISNE, "ISGT": OPS.ISGT,
    "ISLT": OPS.ISLT, "ISGE": OPS.ISGE, "ISLE": OPS.ISLE,
    "LOR": OPS.LOR, "LAND": OPS.LAND, "LXOR": OPS.LXOR, "LXNOR": OPS.LXNOR,
    "EQ": OPS.EQ, "NE": OPS.NE, "GT": OPS.GT, "LT": OPS.LT,
    "GE": OPS.GE, "LE": OPS.LE,
    "BOR": OPS.BOR, "BAND": OPS.BAND, "BXOR": OPS.BXOR, "BXNOR": OPS.BXNOR,
    "POW": OPS.POW, "ATAN2": OPS.ATAN2, "HYPOT": OPS.HYPOT,
    "FMOD": OPS.FMOD, "REMAINDER": OPS.REMAINDER, "LDEXP": OPS.LDEXP,
    "COPYSIGN": OPS.COPYSIGN, "CMPLX": OPS.CMPLX,
    "FIRSTI": OPS.FIRSTI, "FIRSTI1": OPS.FIRSTI1,
    "FIRSTJ": OPS.FIRSTJ, "FIRSTJ1": OPS.FIRSTJ1,
    "SECONDI": OPS.SECONDI, "SECONDI1": OPS.SECONDI1,
    "SECONDJ": OPS.SECONDJ, "SECONDJ1": OPS.SECONDJ1,
}

_MONOID_BY_NAME = {
    "MIN": M.MIN, "MAX": M.MAX, "PLUS": M.PLUS, "TIMES": M.TIMES,
    "ANY": M.ANY, "LOR": M.LOR, "LAND": M.LAND, "LXOR": M.LXOR,
    "EQ": M.LXNOR, "LXNOR": M.LXNOR,
    "BOR": M.BOR, "BAND": M.BAND, "BXOR": M.BXOR, "BXNOR": M.BXNOR,
}

# the 1553-semiring breakdown (GraphBLAS.h:8258-8317)
_SR_1000 = (("MIN", "MAX", "PLUS", "TIMES", "ANY"),
            ("FIRST", "SECOND", "PAIR", "MIN", "MAX", "PLUS", "MINUS",
             "TIMES", "DIV", "RDIV", "RMINUS", "ISEQ", "ISNE", "ISGT",
             "ISLT", "ISGE", "ISLE", "LOR", "LAND", "LXOR"),
            REAL10)
_SR_300 = (("LOR", "LAND", "LXOR", "EQ", "ANY"),
           ("EQ", "NE", "GT", "LT", "GE", "LE"),
           REAL10)
_SR_55 = (("LOR", "LAND", "LXOR", "EQ", "ANY"),
          ("FIRST", "SECOND", "LOR", "LAND", "LXOR", "EQ", "GT", "LT",
           "GE", "LE", "PAIR"),
          ("BOOL",))
_SR_54 = (("PLUS", "TIMES", "ANY"),
          ("FIRST", "SECOND", "PAIR", "PLUS", "MINUS", "TIMES", "DIV",
           "RDIV", "RMINUS"),
          FC2)
_SR_64 = (("BOR", "BAND", "BXOR", "BXNOR"),
          ("BOR", "BAND", "BXOR", "BXNOR"),
          UINT4)
_SR_80 = (("MIN", "MAX", "PLUS", "TIMES", "ANY"),
          ("FIRSTI", "FIRSTI1", "FIRSTJ", "FIRSTJ1", "SECONDI", "SECONDI1",
           "SECONDJ", "SECONDJ1"),
          ("INT32", "INT64"))
_SEMIRING_GROUPS = (_SR_1000, _SR_300, _SR_55, _SR_54, _SR_64, _SR_80)

# GrB (spec) semirings: GrB_{ADD}_{MULT}_SEMIRING_{T} — 124 aliases
# (GraphBLAS.h GrB_PLUS_TIMES_SEMIRING_* section).
_GRB_SR_REAL = ("PLUS_TIMES", "PLUS_MIN", "MIN_PLUS", "MIN_TIMES",
                "MIN_FIRST", "MIN_SECOND", "MIN_MAX", "MAX_PLUS",
                "MAX_TIMES", "MAX_FIRST", "MAX_SECOND", "MAX_MIN")
_GRB_SR_BOOL = ("LOR_LAND", "LAND_LOR", "LXOR_LAND", "LXNOR_LOR")


def _as_type(x, ty):
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x)
    return T.cast(x, ty)


def _typed_fn(fn, ty):
    def f(x, y):
        x, y = OPS._pair(x, y)
        return fn(T.cast(x, ty), T.cast(y, ty))
    return f


def _typed_binop(base: BinaryOp, tname: str, full: str) -> BinaryOp:
    """Typed view of a polymorphic binary op: inputs cast to the declared
    domain first (spec: inputs are typecast to the operator's domain)."""
    ty = TYPE_BY_SUFFIX[tname]
    if base.positional:
        return dataclasses.replace(base, name=full)
    return BinaryOp(full, _typed_fn(base.fn, ty), ztype=base.ztype,
                    commutative=base.commutative)


def _typed_unop(base: UnaryOp, tname: str, full: str) -> UnaryOp:
    ty = TYPE_BY_SUFFIX[tname]
    if base.positional:
        return dataclasses.replace(base, name=full)
    fn = base.fn

    def f(x):
        return fn(_as_type(x, ty))
    return UnaryOp(full, f, ztype=base.ztype)


# ---------------------------------------------------------------------------
# name generators (lazy: names first, objects on lookup)
# ---------------------------------------------------------------------------

def semiring_names() -> tuple:
    """All 1553 GxB semiring names (reference: GraphBLAS.h:8252-8345)."""
    out = []
    for adds, mults, types in _SEMIRING_GROUPS:
        for a in adds:
            for m in mults:
                for t in types:
                    out.append(f"GxB_{a}_{m}_{t}")
    return tuple(out)


def grb_semiring_names() -> tuple:
    out = [f"GrB_{am}_SEMIRING_{t}" for am in _GRB_SR_REAL for t in REAL10]
    out += [f"GrB_{am}_SEMIRING_BOOL" for am in _GRB_SR_BOOL]
    return tuple(out)


def monoid_names() -> tuple:
    """All 77 GxB monoid names (reference: Source/GB_ops.c:584-660):
    5 x 10 real + 5 bool + 4 x 4 bitwise + 3 x 2 complex."""
    out = []
    for op in ("MIN", "MAX", "PLUS", "TIMES", "ANY"):
        out += [f"GxB_{op}_{t}_MONOID" for t in REAL10]
    out += [f"GxB_{op}_BOOL_MONOID"
            for op in ("LOR", "LAND", "LXOR", "EQ", "ANY")]
    for op in ("BOR", "BAND", "BXOR", "BXNOR"):
        out += [f"GxB_{op}_{t}_MONOID" for t in UINT4]
    for op in ("PLUS", "TIMES", "ANY"):
        out += [f"GxB_{op}_{t}_MONOID" for t in FC2]
    return tuple(out)


def grb_monoid_names() -> tuple:
    out = []
    for op in ("MIN", "MAX", "PLUS", "TIMES"):
        out += [f"GrB_{op}_MONOID_{t}" for t in REAL10]
    out += [f"GrB_{op}_MONOID_BOOL" for op in ("LOR", "LAND", "LXOR",
                                               "LXNOR")]
    return tuple(out)


def binary_op_names() -> tuple:
    """Typed binary-op names (reference: ~300+ in Include/GraphBLAS.h)."""
    out = []
    for op in ("FIRST", "SECOND", "ONEB", "PLUS", "MINUS", "TIMES", "DIV"):
        out += [f"GrB_{op}_{t}" for t in ALL13]
    for op in ("MIN", "MAX"):
        out += [f"GrB_{op}_{t}" for t in ("BOOL",) + REAL10]
    for op in ("EQ", "NE"):
        out += [f"GrB_{op}_{t}" for t in ALL13]
    for op in ("GT", "LT", "GE", "LE"):
        out += [f"GrB_{op}_{t}" for t in ("BOOL",) + REAL10]
    for op in ("LOR", "LAND", "LXOR"):
        out += [f"GrB_{op}_{t}" for t in ("BOOL",) + REAL10]
    for op in ("PAIR", "ANY", "RMINUS", "RDIV", "ISEQ", "ISNE", "ISGT",
               "ISLT", "ISGE", "ISLE"):
        out += [f"GxB_{op}_{t}" for t in ("BOOL",) + REAL10]
    out += [f"GxB_POW_{t}" for t in ALL13]
    for op in ("BOR", "BAND", "BXOR", "BXNOR"):
        out += [f"GrB_{op}_{t}" for t in INT8T]
    for op in ("ATAN2", "HYPOT", "FMOD", "REMAINDER", "LDEXP", "COPYSIGN",
               "CMPLX"):
        out += [f"GxB_{op}_{t}" for t in FP2]
    for op in ("FIRSTI", "FIRSTI1", "FIRSTJ", "FIRSTJ1", "SECONDI",
               "SECONDI1", "SECONDJ", "SECONDJ1"):
        out += [f"GxB_{op}_{t}" for t in ("INT32", "INT64")]
    return tuple(out)


_UNARY_FP = ("SQRT", "LOG", "EXP", "LOG2", "SIN", "COS", "TAN", "ASIN",
             "ACOS", "ATAN", "SINH", "COSH", "TANH", "ASINH", "ACOSH",
             "ATANH", "SIGNUM", "CEIL", "FLOOR", "ROUND", "TRUNC", "EXP2",
             "EXPM1", "LOG10", "LOG1P", "LGAMMA", "TGAMMA", "ERF", "ERFC",
             "CBRT", "FREXPX", "FREXPE")


def unary_op_names() -> tuple:
    """Typed unary-op names (reference: ~80 distinct ops x types)."""
    out = []
    for op in ("IDENTITY", "AINV", "MINV", "ABS"):
        out += [f"GrB_{op}_{t}" for t in ALL13]
    out += ["GrB_LNOT"] + [f"GxB_LNOT_{t}" for t in ("BOOL",) + REAL10]
    out += [f"GrB_BNOT_{t}" for t in INT8T]
    out += [f"GxB_ONE_{t}" for t in ALL13]
    for op in _UNARY_FP:
        fps = FP2 if op in ("LGAMMA", "TGAMMA", "ERF", "ERFC", "CBRT",
                            "FREXPX", "FREXPE") else FP2 + FC2
        out += [f"GxB_{op}_{t}" for t in fps]
    for op in ("ISINF", "ISNAN", "ISFINITE"):
        out += [f"GxB_{op}_{t}" for t in FP2 + FC2]
    for op in ("CONJ", "CREAL", "CIMAG", "CARG"):
        out += [f"GxB_{op}_{t}" for t in FC2]
    for op in ("POSITIONI", "POSITIONI1", "POSITIONJ", "POSITIONJ1"):
        out += [f"GxB_{op}_{t}" for t in ("INT32", "INT64")]
    return tuple(out)


def index_unary_op_names() -> tuple:
    out = []
    for op in ("ROWINDEX", "COLINDEX", "DIAGINDEX"):
        out += [f"GrB_{op}_{t}" for t in ("INT32", "INT64")]
    out += [f"GrB_{op}" for op in ("TRIL", "TRIU", "DIAG", "OFFDIAG",
                                   "COLLE", "COLGT", "ROWLE", "ROWGT")]
    for op in ("VALUEEQ", "VALUENE"):
        out += [f"GrB_{op}_{t}" for t in ALL13]
    for op in ("VALUEGT", "VALUEGE", "VALUELT", "VALUELE"):
        out += [f"GrB_{op}_{t}" for t in ("BOOL",) + REAL10]
    return tuple(out)


def type_names() -> tuple:
    return tuple(ty.name for ty in TYPE_BY_SUFFIX.values())


# ---------------------------------------------------------------------------
# lookup
# ---------------------------------------------------------------------------

_cache: dict = {}


def _build_semiring(prefix: str, add: str, mult: str, tname: str,
                    full: str) -> Semiring:
    ty = TYPE_BY_SUFFIX[tname]
    mon = _MONOID_BY_NAME[add]
    # the multiply is the TYPED view: inputs typecast to the declared
    # domain first (spec; the raw polymorphic op would compute in the
    # operands' dtype).  The base name is kept so name-keyed kernel fast
    # paths still match.
    mop = _typed_binop(_MULT_BY_NAME[mult], tname, _MULT_BY_NAME[mult].name)
    return Semiring(dataclasses.replace(mon, declared_type=ty), mop,
                    name=full, declared_type=ty)


def lookup(name: str):
    """Resolve any predefined GrB_/GxB_ name to its object.  Raises
    KeyError for unknown names (mirrors GrB_INVALID_VALUE)."""
    obj = _cache.get(name)
    if obj is not None:
        return obj
    obj = _resolve(name)
    _cache[name] = obj
    return obj


def _resolve(name: str):
    for ty in TYPE_BY_SUFFIX.values():
        if name == ty.name:
            return ty
    if not (name.startswith("GrB_") or name.startswith("GxB_")):
        raise KeyError(name)
    body = name[4:]
    # semirings: GxB_{ADD}_{MULT}_{T} / GrB_{ADD}_{MULT}_SEMIRING_{T}
    if "_SEMIRING_" in body:
        am, t = body.split("_SEMIRING_")
        a, m = am.split("_", 1)
        return _build_semiring("GrB", a, m, t, name)
    if body.endswith("_MONOID") or "_MONOID_" in body:
        # GxB_{OP}_{T}_MONOID or GrB_{OP}_MONOID_{T}
        if body.endswith("_MONOID"):
            core = body[:-len("_MONOID")]
            op, t = core.rsplit("_", 1)
        else:
            op, t = body.split("_MONOID_")
        mon = _MONOID_BY_NAME.get(op)
        if mon is None or t not in TYPE_BY_SUFFIX:
            raise KeyError(name)
        return dataclasses.replace(mon, name=name,
                                   declared_type=TYPE_BY_SUFFIX[t])
    parts = body.split("_")
    # GxB_{ADD}_{MULT}_{T} semiring?
    if len(parts) == 3 and parts[0] in _MONOID_BY_NAME and \
            parts[1] in _MULT_BY_NAME and parts[2] in TYPE_BY_SUFFIX:
        return _build_semiring("GxB", parts[0], parts[1], parts[2], name)
    # positional semirings have a numeral suffix inside the mult name
    if len(parts) == 3 and parts[0] in _MONOID_BY_NAME and \
            parts[2] in TYPE_BY_SUFFIX and parts[1] in _MULT_BY_NAME:
        return _build_semiring("GxB", parts[0], parts[1], parts[2], name)
    # index-unary ops
    iu = {"ROWINDEX": OPS.ROWINDEX, "COLINDEX": OPS.COLINDEX,
          "DIAGINDEX": OPS.DIAGINDEX, "TRIL": OPS.TRIL, "TRIU": OPS.TRIU,
          "DIAG": OPS.DIAG, "OFFDIAG": OPS.OFFDIAG, "COLLE": OPS.COLLE,
          "COLGT": OPS.COLGT, "ROWLE": OPS.ROWLE, "ROWGT": OPS.ROWGT,
          "VALUEEQ": OPS.VALUEEQ, "VALUENE": OPS.VALUENE,
          "VALUEGT": OPS.VALUEGT, "VALUEGE": OPS.VALUEGE,
          "VALUELT": OPS.VALUELT, "VALUELE": OPS.VALUELE}
    if parts[0] in iu:
        return dataclasses.replace(iu[parts[0]], name=name)
    # typed binary / unary ops: {OP}_{T} (or bare GrB_LNOT)
    un = {"IDENTITY": OPS.IDENTITY, "AINV": OPS.AINV, "MINV": OPS.MINV,
          "ABS": OPS.ABS, "LNOT": OPS.LNOT, "BNOT": OPS.BNOT,
          "ONE": OPS.ONE, "ISINF": OPS.ISINF, "ISNAN": OPS.ISNAN,
          "ISFINITE": OPS.ISFINITE, "CONJ": OPS.CONJ, "CREAL": OPS.CREAL,
          "CIMAG": OPS.CIMAG, "CARG": OPS.CARG,
          "POSITIONI": OPS.POSITIONI, "POSITIONI1": OPS.POSITIONI1,
          "POSITIONJ": OPS.POSITIONJ, "POSITIONJ1": OPS.POSITIONJ1,
          **{u: getattr(OPS, u) for u in _UNARY_FP}}
    if body == "LNOT":
        return OPS.LNOT
    if len(parts) >= 2 and parts[-1] in TYPE_BY_SUFFIX:
        op, t = "_".join(parts[:-1]), parts[-1]
        if op in un:
            return _typed_unop(un[op], t, name)
        if op in _MULT_BY_NAME:
            return _typed_binop(_MULT_BY_NAME[op], t, name)
    raise KeyError(name)


def __getattr__(attr: str):
    """Module-level attribute access: names.GxB_MIN_PLUS_FP32 etc."""
    try:
        return lookup(attr)
    except KeyError:
        raise AttributeError(attr) from None
