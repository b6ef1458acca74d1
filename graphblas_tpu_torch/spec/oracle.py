"""Executable specification: dense numpy mimics of every GraphBLAS op
(counterpart of ``graphblas_tpu.spec.oracle``).

A naive, obviously-correct dense implementation with explicit pattern
arrays, in the manner of the reference's Octave spec files
(Test/GB_spec_mxm.m, GB_spec_accum_mask.m, ...): it defines the
semantics (typecast order, accum/mask behavior, descriptor handling)
independently of the optimized library, and the tests sweep random
matrices through both and compare.

Everything here is plain numpy on (values, pattern) pairs, clarity over
speed, except the operators themselves: they are the port's torch
callables, evaluated on CPU tensors made from the numpy inputs (the same
typed entry the library calls, which computes the unsigned types
through their signed carriers), and their results come back as numpy.
Where this spec differs from the JAX package's:

* a ``SpecMat`` names its GraphBLAS type: BF16 values travel as float32
  (``types.BF16``), and a struct type's field axes trail the (m, n)
  pattern axes;
* casts follow the port's ``types.cast``: float -> INT64 / UINT64
  saturates at the exact maximum;
* a positional multiply (FIRSTI1, ...) is the entry's coordinate, + 1
  for the 1-based ops, and not the op's callable applied again;
* BF16 is rounded after every operator, as the JAX package computes it;
  the port's PLUS reductions of BF16 add in float32 and round once, so
  the two agree where every partial sum is exact in bf16.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.monoid import Monoid
from ..core.ops import BinaryOp, IndexUnaryOp, UnaryOp
from ..core.semiring import Semiring


@dataclasses.dataclass
class SpecMat:
    """Dense (values, pattern) pair of a GraphBLAS type: values
    (m, n, *field shape) of the type's host dtype, pattern bool (m, n)."""

    values: np.ndarray
    pattern: np.ndarray
    type: Optional[T.Type] = None     # default: the type of values' dtype

    def __post_init__(self):
        self.values = np.asarray(self.values)
        self.pattern = np.asarray(self.pattern, bool)
        self.type = T.lookup(self.values.dtype if self.type is None
                             else self.type)

    @classmethod
    def empty(cls, shape, dtype):
        ty = T.lookup(dtype)
        return cls(np.zeros(tuple(shape) + ty.shape, ty.np_dtype),
                   np.zeros(shape, bool), ty)

    @classmethod
    def from_gb(cls, A):
        v, p = A.to_dense_pair()
        return cls(T.host(v), T.host(p), A.dtype)

    @property
    def shape(self):
        return self.pattern.shape

    @property
    def dtype(self) -> T.Type:
        return self.type

    def copy(self):
        return SpecMat(self.values.copy(), self.pattern.copy(), self.type)

    def cast(self, dtype):
        ty = T.lookup(dtype)
        out = _cast_np(self.values, ty, self.type)
        return SpecMat(_where(self.pattern, out, _zero(ty)),
                       self.pattern.copy(), ty)


def _zero(ty: T.Type):
    return np.zeros((), ty.np_dtype)


def _where(m, a, b):
    """np.where with the (m, n) mask over a struct's trailing field axes."""
    a = np.asarray(a)
    m = np.asarray(m)
    return np.where(m.reshape(m.shape + (1,) * (a.ndim - m.ndim)), a, b)


def _round_bf16(x):
    """numpy values rounded to bf16 as the port's cast rounds them (in
    torch), on the float32 carrier."""
    x = np.asarray(x)
    if x.dtype == np.uint64:
        x = x.astype(np.float64)
    elif x.dtype in (np.uint16, np.uint32):
        x = x.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        torch.bfloat16).float().numpy()


def _cast_np(vals, to, src=None):
    """numpy version of the port's ``types.cast``: float -> int rounds to
    nearest, NaN -> 0, and saturates (64-bit targets at their exact
    maximum); int -> unsigned wraps at 2^w; complex -> real takes the
    real part; anything -> bool is x != 0.  ``src`` is the values' type
    when their dtype does not name it (BF16, a struct)."""
    to = T.lookup(to)
    a = np.asarray(vals)
    src = T.lookup(a.dtype if src is None else src)
    if to.is_struct or src == to:
        return a.astype(to.np_dtype)
    if to.is_bool:
        return a != 0
    real = a.real if src.is_complex else a
    if to == T.BF16:
        return _round_bf16(real)
    dt = to.np_dtype
    if to.is_integer and (src.is_float or src.is_complex):
        info = np.iinfo(dt)
        with np.errstate(invalid="ignore"):
            r = np.rint(real.astype(np.float64))
            r = np.where(np.isnan(r), 0.0, r)
        if info.bits <= 32:
            return np.clip(r, float(info.min), float(info.max)).astype(dt)
        lo = r < float(info.min)
        hi = r >= 2.0 ** (63 if to.is_signed else 64)
        with np.errstate(invalid="ignore"):
            out = np.where(lo | hi, 0.0, r).astype(dt)
        return np.where(hi, info.max, np.where(lo, info.min, out)).astype(dt)
    if not to.is_complex and src.is_complex:
        return real.astype(dt)
    return a.astype(dt)


def _tensor(x, ty=None):
    """A CPU tensor of the numpy value ``x`` (of type ``ty``, else of its
    own dtype)."""
    x = np.asarray(x)
    return T.from_host(x, T.lookup(x.dtype if ty is None else ty), "cpu")


def _apply_np(fn, *args, types=()):
    """Evaluate a port op callable on numpy inputs: each argument becomes
    a CPU tensor of its type (``types``, else its dtype's; an argument
    that is already a tensor stays one), the result comes back as numpy
    (BF16 as float32)."""
    types = tuple(types) + (None,) * (len(args) - len(types))
    out = fn(*(a if isinstance(a, torch.Tensor) else _tensor(a, t)
               for a, t in zip(args, types)))
    return T.host(out) if isinstance(out, torch.Tensor) else np.asarray(out)


# ---------------------------------------------------------------------------
# accum / mask (reference: Test/GB_spec_accum_mask.m semantics)
# ---------------------------------------------------------------------------

def spec_accum(C: SpecMat, T_: SpecMat, accum: BinaryOp | None,
               out_dtype) -> SpecMat:
    """Z = accum(C, T): union pattern; both -> accum, single -> passthrough
    (typecast to C's type)."""
    ty = T.lookup(out_dtype)
    if accum is None:
        return T_.cast(ty)
    both = C.pattern & T_.pattern
    only_c = C.pattern & ~T_.pattern
    only_t = T_.pattern & ~C.pattern
    z = np.zeros(C.shape + ty.shape, ty.np_dtype)
    if both.any():
        z[both] = _cast_np(_apply_np(accum.fn, C.values[both],
                                     T_.values[both],
                                     types=(C.type, T_.type)), ty)
    z[only_c] = _cast_np(C.values[only_c], ty, C.type)
    z[only_t] = _cast_np(T_.values[only_t], ty, T_.type)
    return SpecMat(z, C.pattern | T_.pattern, ty)


def _mask_values(M: SpecMat) -> np.ndarray:
    nz = M.values != 0
    return nz.reshape(M.shape + (-1,)).any(-1) if M.type.is_struct else nz


def spec_mask(C: SpecMat, M: SpecMat | None, Z: SpecMat,
              desc: Descriptor) -> SpecMat:
    """R = C where !m, Z where m (with replace/complement/structure)."""
    if M is None:
        m = np.ones(C.shape, bool)
    else:
        m = M.pattern.copy() if desc.mask_structure else (
            M.pattern & _mask_values(M))
    if desc.mask_complement:
        m = ~m
    rvals = _where(m, Z.values, C.values)
    if desc.replace:
        rpat = Z.pattern & m
    else:
        rpat = np.where(m, Z.pattern, C.pattern)
    return SpecMat(_where(rpat, rvals, _zero(C.type)), rpat, C.type)


def spec_accum_mask(C: SpecMat, M: SpecMat | None, accum, T_: SpecMat,
                    desc: Descriptor) -> SpecMat:
    Z = spec_accum(C, T_, accum, C.type)
    return spec_mask(C, M, Z, desc)


def _maybe_t(A: SpecMat, tran: bool) -> SpecMat:
    if not tran:
        return A
    return SpecMat(np.swapaxes(A.values, 0, 1), A.pattern.T, A.type)


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------

def _positional_sub(kind, i, k, j):
    """The coordinate a positional multiply of a(i, k) * b(k, j) gives."""
    return {"firsti": i, "firsti1": i + 1, "firstj": k, "firstj1": k + 1,
            "secondi": k, "secondi1": k + 1, "secondj": j,
            "secondj1": j + 1}[kind]


def mxm_type(sr: Semiring, atype, btype) -> T.Type:
    """The product's type: a named semiring's declared type (its mult's
    bool for a comparator), else the mult's output type."""
    dt = sr.declared_type
    if dt is not None:
        return dt if sr.mult.positional else (sr.mult.ztype or dt)
    return sr.mult.out_type(T.lookup(atype), T.lookup(btype))


def spec_mxm(C, M, accum, sr: Semiring, A: SpecMat, B: SpecMat,
             desc: Descriptor = NULL) -> SpecMat:
    """C<M> = accum(C, A (+) . (x) B): every product t(i, k, j) of the
    dense triple loop, then the add monoid folded over k in order."""
    A = _maybe_t(A, desc.transpose0)
    B = _maybe_t(B, desc.transpose1)
    m, k = A.shape
    k2, n = B.shape
    assert k == k2
    mult, add = sr.mult, sr.add
    zt = mxm_type(sr, A.type, B.type)
    tvals = np.zeros((m, n) + zt.shape, zt.np_dtype)
    tpat = np.zeros((m, n), bool)
    ii, jj = np.indices((m, n))
    for kk in range(k):
        live = A.pattern[:, kk][:, None] & B.pattern[kk, :][None, :]
        if not live.any():
            continue
        if mult.positional:
            t = np.broadcast_to(_positional_sub(mult.positional, ii, kk, jj),
                                (m, n))[live]
        else:
            x = np.broadcast_to(A.values[:, kk][:, None], tvals.shape)
            y = np.broadcast_to(B.values[kk, :][None, :], tvals.shape)
            t = _apply_np(mult.fn, x[live], y[live],
                          types=(A.type, B.type))
        t = _cast_np(t, zt)
        both = live & tpat
        if both[live].any():
            t[both[live]] = _cast_np(_apply_np(
                add.op.fn, tvals[both], t[both[live]], types=(zt, zt)), zt)
        tvals[live] = t
        tpat |= live
    return spec_accum_mask(C, M, accum, SpecMat(tvals, tpat, zt), desc)


def _ewise(op: BinaryOp, A: SpecMat, B: SpecMat, av, bv, where_):
    zt = op.out_type(A.type, B.type)
    tvals = np.zeros(A.shape + zt.shape, zt.np_dtype)
    if where_.any():
        tvals[where_] = _cast_np(_apply_np(op.fn, av[where_], bv[where_],
                                           types=(A.type, B.type)), zt)
    return zt, tvals


def spec_ewise_add(C, M, accum, op: BinaryOp, A: SpecMat, B: SpecMat,
                   desc: Descriptor = NULL) -> SpecMat:
    A = _maybe_t(A, desc.transpose0)
    B = _maybe_t(B, desc.transpose1)
    zt, tvals = _ewise(op, A, B, A.values, B.values, A.pattern & B.pattern)
    onlya = A.pattern & ~B.pattern
    onlyb = B.pattern & ~A.pattern
    tvals[onlya] = _cast_np(A.values[onlya], zt, A.type)
    tvals[onlyb] = _cast_np(B.values[onlyb], zt, B.type)
    return spec_accum_mask(C, M, accum,
                           SpecMat(tvals, A.pattern | B.pattern, zt), desc)


def spec_ewise_mult(C, M, accum, op: BinaryOp, A: SpecMat, B: SpecMat,
                    desc: Descriptor = NULL) -> SpecMat:
    A = _maybe_t(A, desc.transpose0)
    B = _maybe_t(B, desc.transpose1)
    both = A.pattern & B.pattern
    zt, tvals = _ewise(op, A, B, A.values, B.values, both)
    return spec_accum_mask(C, M, accum, SpecMat(tvals, both, zt), desc)


def spec_ewise_union(C, M, accum, op: BinaryOp, A: SpecMat, alpha,
                     B: SpecMat, beta, desc: Descriptor = NULL) -> SpecMat:
    """The union, an entry present on one side only meeting the other
    side's fill scalar (alpha for A, beta for B, each of its side's
    type)."""
    A = _maybe_t(A, desc.transpose0)
    B = _maybe_t(B, desc.transpose1)
    av = _where(A.pattern, A.values, _cast_np(alpha, A.type))
    bv = _where(B.pattern, B.values, _cast_np(beta, B.type))
    union = A.pattern | B.pattern
    zt, tvals = _ewise(op, A, B, av, bv, union)
    return spec_accum_mask(C, M, accum, SpecMat(tvals, union, zt), desc)


_POS_UNARY = {"i": (0, 0), "i1": (0, 1), "j": (1, 0), "j1": (1, 1)}
_POS_BINARY = {"firsti": "i", "secondi": "i", "firsti1": "i1",
               "secondi1": "i1", "firstj": "j", "secondj": "j",
               "firstj1": "j1", "secondj1": "j1"}


def spec_apply(C, M, accum, op, A: SpecMat, desc: Descriptor = NULL,
               bind=None, thunk=None) -> SpecMat:
    """T = op(A) on A's pattern: a unary op, an index-unary op with its
    thunk, or a binary op with one side bound (``bind`` = ("first" |
    "second", scalar); a Python float binds as FP64).  A positional op
    gives the entry's coordinate (a positional binary op ignores the
    bound scalar)."""
    A = _maybe_t(A, desc.transpose0)
    ii, jj = np.indices(A.shape)
    pos = op.positional if isinstance(op, UnaryOp) else \
        _POS_BINARY.get(op.positional) if isinstance(op, BinaryOp) else None
    if pos:
        zt = op.out_type(A.type) if isinstance(op, UnaryOp) else T.INT64
        axis, plus = _POS_UNARY[pos]
        out = (ii, jj)[axis] + plus
    elif isinstance(op, UnaryOp):
        zt = op.out_type(A.type)
        out = np.zeros(A.shape + zt.shape, zt.np_dtype)
        if A.pattern.any():
            out[A.pattern] = _cast_np(_apply_np(
                op.fn, A.values[A.pattern], types=(A.type,)), zt)
    elif isinstance(op, IndexUnaryOp):
        zt = op.out_type(A.type)
        th = torch.as_tensor(0 if thunk is None else thunk)
        out = _apply_np(op.fn, A.values, ii, jj, th, types=(A.type,))
    else:
        which, scalar = bind
        s = np.asarray(scalar)
        sty = T.lookup(s.dtype)
        st = _tensor(s, sty)                 # 0-d, as the library binds it
        if which == "first":
            zt = op.out_type(sty, A.type)
            out = _apply_np(op.fn, st, A.values, types=(sty, A.type))
        else:
            zt = op.out_type(A.type, sty)
            out = _apply_np(op.fn, A.values, st, types=(A.type, sty))
    tvals = _where(A.pattern, _cast_np(out, zt), _zero(zt))
    return spec_accum_mask(C, M, accum,
                           SpecMat(tvals, A.pattern.copy(), zt), desc)


def spec_select(C, M, accum, op: IndexUnaryOp, A: SpecMat, thunk,
                desc: Descriptor = NULL) -> SpecMat:
    """Keep A's entries where op(a, i, j, thunk) != 0 (a value thunk
    against an unsigned A takes A's type, as the library makes it)."""
    A = _maybe_t(A, desc.transpose0)
    ii, jj = np.indices(A.shape)
    if op.value_only and T.wide_unsigned(A.type):
        th = _tensor(np.asarray(thunk), A.type)
    else:
        th = torch.as_tensor(thunk)
    keep = np.asarray(_apply_np(op.fn, A.values, ii, jj, th,
                                types=(A.type,))) != 0
    keep = keep & A.pattern
    tvals = _where(keep, A.values, _zero(A.type))
    return spec_accum_mask(C, M, accum, SpecMat(tvals, keep, A.type), desc)


def _fold(mon: Monoid, ty: T.Type, acc, v):
    return _cast_np(_apply_np(mon.op.fn, acc, v, types=(ty, ty)), ty)


def spec_reduce_vector(C, M, accum, mon: Monoid, A: SpecMat,
                       desc: Descriptor = NULL) -> SpecMat:
    """w<m> = accum(w, reduce-rows(A)): the monoid folded along each row
    in column order."""
    A = _maybe_t(A, desc.transpose0)
    m, n = A.shape
    ty = A.type
    tvals = np.zeros((m, 1) + ty.shape, ty.np_dtype)
    tpat = np.zeros((m, 1), bool)
    for j in range(n):
        live = A.pattern[:, j]
        both = live & tpat[:, 0]
        v = A.values[:, j].copy()
        if both.any():
            v[both] = _fold(mon, ty, tvals[both, 0], v[both])
        tvals[live, 0] = v[live]
        tpat[live, 0] = True
    return spec_accum_mask(C, M, accum, SpecMat(tvals, tpat, ty), desc)


def spec_reduce_scalar(mon: Monoid, A: SpecMat, accum=None, init=None):
    """The monoid folded over A's entries in row-major order (its
    identity when A is empty), then accum(init, s)."""
    ty = A.type
    acc = None
    for v in A.values[A.pattern]:
        acc = v if acc is None else _fold(mon, ty, acc, v)
    if acc is None:
        acc = _cast_np(np.asarray(mon.identity_for(ty.np_dtype)), ty)
    if accum is not None and init is not None:
        acc = _cast_np(_apply_np(accum.fn, _cast_np(init, ty), acc,
                                 types=(ty, ty)), ty)
    return np.asarray(acc)[()]


def spec_transpose(C, M, accum, A: SpecMat, desc: Descriptor = NULL
                   ) -> SpecMat:
    # NOTE: GrB_transpose with desc.transpose0 set means NO transpose
    A2 = A if desc.transpose0 else _maybe_t(A, True)
    return spec_accum_mask(C, M, accum, A2.copy(), desc)


def spec_extract(C, M, accum, A: SpecMat, I, J,
                 desc: Descriptor = NULL) -> SpecMat:
    A = _maybe_t(A, desc.transpose0)
    sub = SpecMat(A.values[np.ix_(I, J)], A.pattern[np.ix_(I, J)], A.type)
    return spec_accum_mask(C, M, accum, sub, desc)


def spec_subassign(C: SpecMat, M, accum, A: SpecMat, I, J,
                   desc: Descriptor = NULL) -> SpecMat:
    """GxB_subassign: mask is over C(I,J) (reference: GrB_assign vs
    GxB_subassign mask-scope distinction, Source/GB_assign.c)."""
    sub = SpecMat(C.values[np.ix_(I, J)], C.pattern[np.ix_(I, J)], C.type)
    newsub = spec_accum_mask(sub, M, accum, A, desc)
    R = C.copy()
    R.values[np.ix_(I, J)] = _cast_np(newsub.values, C.type, newsub.type)
    R.pattern[np.ix_(I, J)] = newsub.pattern
    R.values[~R.pattern] = 0
    return R


def spec_assign(C: SpecMat, M, accum, A: SpecMat, I, J,
                desc: Descriptor = NULL) -> SpecMat:
    """GrB_assign: mask is over all of C; outside C(I, J), C is untouched
    except under replace where the mask excludes it."""
    T_ = C.copy()
    sub = SpecMat(C.values[np.ix_(I, J)], C.pattern[np.ix_(I, J)], C.type)
    z = spec_accum(sub, A.cast(C.type), accum, C.type)
    T_.values[np.ix_(I, J)] = z.values
    T_.pattern[np.ix_(I, J)] = z.pattern
    R = spec_mask(C, M, T_, desc)
    if not desc.replace:
        out = np.ones(C.shape, bool)
        out[np.ix_(I, J)] = False
        R.pattern[out] = C.pattern[out]
        R.values[out] = C.values[out]
        R.values[~R.pattern] = 0
    return R


def spec_kron(C, M, accum, op: BinaryOp, A: SpecMat, B: SpecMat,
              desc: Descriptor = NULL) -> SpecMat:
    """T(i*p + k, j*q + l) = op(A(i, j), B(k, l)) where both exist."""
    A = _maybe_t(A, desc.transpose0)
    B = _maybe_t(B, desc.transpose1)
    m, n = A.shape
    p, q = B.shape
    tp = np.kron(A.pattern, B.pattern).astype(bool)
    av = A.values.repeat(p, 0).repeat(q, 1)
    bv = np.tile(B.values, (m, n) + (1,) * len(B.type.shape))
    zt = op.out_type(A.type, B.type)
    tv = np.zeros(tp.shape + zt.shape, zt.np_dtype)
    if tp.any():
        tv[tp] = _cast_np(_apply_np(op.fn, av[tp], bv[tp],
                                    types=(A.type, B.type)), zt)
    return spec_accum_mask(C, M, accum, SpecMat(tv, tp, zt), desc)
