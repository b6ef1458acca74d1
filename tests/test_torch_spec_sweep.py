"""The port's op layer on the CPU against the port's own executable spec
(graphblas_tpu_torch/spec/oracle.py), on a fixed sample of the cross
product of ops, types, storage formats, orientations, masks,
descriptors and accumulators:

* mxm over PLUS_TIMES FP64, MIN_PLUS INT32, LOR_LAND BOOL, PLUS_TIMES
  UINT16 and MAX_FIRST INT8;
* ewise_add / ewise_mult / ewise_union with six operators over FP32,
  INT16 and UINT32;
* extract, subassign, assign, kronecker, transpose and the row reduce
  over FP64, INT16, UINT64 and BOOL;
* user-defined torch operators (a binary op, a unary op through apply,
  the log-sum-exp monoid in mxm, the Gauss-integer struct semiring) and
  BF16 (ewise, apply, mxm, reduce; values whose partial sums are exact
  in bf16, so the port's float32 accumulation and the spec's per-op
  rounding agree).

Each operand is a random (values, pattern) pair at 5x5 to 12x18 built in
one of the four formats, by row or by column; the mask is absent,
valued (with explicit zeros) or structural; the descriptor sets
complement, replace and the input transposes.  Values are small
integers (halves for the floats), so every sum is exact in any order and
the answers must agree bitwise; the log-sum-exp semiring, whose fold
order differs, within 1e-12 relative.  The sample is drawn once from a
fixed seed.
"""

import itertools
import random

import numpy as np
import pytest
import torch

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.core import types as TT
from graphblas_tpu_torch.core.convert import _reclass
from graphblas_tpu_torch.examples import gauss_demo, semiring_demo
from graphblas_tpu_torch.spec import oracle as TS
from torch_parity import cpu_default  # noqa: F401  (autouse fixture)

FORMATS = ("sparse", "hyper", "bitmap", "full")
ORIENTS = ("row", "col")
MASKS = (None, "valued", "structural")
FLAGS = ("", "C", "R", "CR")

MXM = [("PLUS_TIMES", "FP64"), ("MIN_PLUS", "INT32"), ("LOR_LAND", "BOOL"),
       ("PLUS_TIMES", "UINT16"), ("MAX_FIRST", "INT8")]
EWISE_OPS = ("PLUS", "MINUS", "TIMES", "MIN", "MAX", "DIV")
EWISE_TYPES = ("FP32", "INT16", "UINT32")
REST = ("extract", "subassign", "assign", "kronecker", "transpose",
        "reduce")
REST_TYPES = ("FP64", "INT16", "UINT64", "BOOL")
USER = ("hypot", "twice_minus", "clip03_apply", "lse_mxm", "gauss_mxm",
        "gauss_ewise", "select_gt")
BF16 = ("ewise_add", "ewise_mult", "apply_ainv", "mxm", "reduce",
        "transpose")


def _cases():
    """The fixed sample: (family, op, type name, setting tuple)."""
    pick = random.Random(11)
    settings = list(itertools.product(FORMATS, FORMATS, ORIENTS, MASKS,
                                      FLAGS, (False, True), (False, True)))
    out = []

    def take(family, op, tname, k):
        for s in pick.sample(settings, k):
            out.append((family, op, tname, s))

    for op, tname in MXM:
        take("mxm", op, tname, 16)
    for mode in ("add", "mult", "union"):
        for op in EWISE_OPS:
            for tname in EWISE_TYPES:
                take(f"ewise_{mode}", op, tname, 4)
    for op in REST:
        for tname in REST_TYPES:
            take(op, "", tname, 6)
    for op in USER:
        take("user", op, "", 8)
    for op in BF16:
        take("bf16", op, "BF16", 6)
    return out


CASES = _cases()


def _id(case):
    family, op, tname, (fa, fb, orient, mask, flags, accum, tran) = case
    return "-".join(x for x in (family, op, tname, f"{fa[0]}{fb[0]}",
                                orient, mask or "nomask", flags or "plain",
                                "acc" if accum else "", "T" if tran else "")
                    if x)


def _values(rng, shape, ty):
    if ty.is_struct:
        return rng.integers(-3, 4, shape + ty.shape).astype(ty.np_dtype)
    if ty.is_bool:
        return rng.random(shape) < 0.5
    if ty == TT.BF16:
        return rng.integers(0, 4, shape).astype(np.float32)
    if ty.is_float:
        return (rng.integers(-6, 7, shape) / 2).astype(ty.np_dtype)
    if ty.is_signed:
        return rng.integers(-5, 6, shape).astype(ty.np_dtype)
    return rng.integers(0, 7, shape).astype(ty.np_dtype)


def _operand(rng, shape, ty, fmt, orient, density=0.5):
    """(port Matrix in ``fmt``/``orient``, its SpecMat)."""
    p = np.ones(shape, bool) if fmt == "full" else rng.random(shape) < density
    v = _values(rng, shape, ty)
    v[~p] = 0
    vt = TT.from_host(v, ty, "cpu")
    A = gt.Matrix((shape[0], shape[1]), ty, "bitmap", orient, values=vt,
                  bitmap=torch.from_numpy(p))
    A = A.to_format(fmt, orient)
    return A, TS.SpecMat.from_gb(A)


def _mask(rng, shape, kind, fmt, orient):
    if kind is None:
        return None, None
    M, Ms = _operand(rng, shape, TT.INT8 if kind == "valued" else TT.BOOL,
                     "sparse" if fmt == "full" else fmt, orient, 0.6)
    return M, Ms


def _desc(mask, flags, **tran):
    return gt.Descriptor(mask_complement="C" in flags and mask is not None,
                         replace="R" in flags,
                         mask_structure=mask == "structural", **tran)


def _shape(rng):
    return int(rng.integers(5, 13)), int(rng.integers(5, 19))


def _accum(ty, on):
    if not on:
        return None
    if ty.is_struct:
        return gauss_demo.algebra()[1].op
    return gt.operators.LOR if ty.is_bool else gt.operators.PLUS


def _check(got, want, rtol=0.0):
    gs = TS.SpecMat.from_gb(got)
    np.testing.assert_array_equal(gs.pattern, want.pattern)
    assert gs.type == want.type, (gs.type, want.type)
    a = gs.values[gs.pattern]
    b = want.values[want.pattern]
    if rtol:
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(a, b)


def _run_mxm(rng, sr, ty, setting, zt=None, rtol=0.0):
    fa, fb, orient, mask, flags, accum, tran = setting
    (m, n), k = _shape(rng), int(rng.integers(5, 13))
    zt = zt or TS.mxm_type(sr, ty, ty)
    A, As = _operand(rng, (k, m) if tran else (m, k), ty, fa, orient)
    B, Bs = _operand(rng, (k, n), ty, fb, orient)
    C, Cs = _operand(rng, (m, n), zt, "bitmap", orient)
    M, Ms = _mask(rng, (m, n), mask, fb, orient)
    d = _desc(mask, flags, transpose0=tran)
    acc = _accum(zt, accum)
    got = gt.mxm(A, B, sr, C=C, mask=M, accum=acc, desc=d)
    _check(got, TS.spec_mxm(Cs, Ms, acc, sr, As, Bs, d), rtol)


def _run_ewise(rng, mode, op, ty, setting):
    fa, fb, orient, mask, flags, accum, tran = setting
    m, n = _shape(rng)
    A, As = _operand(rng, (n, m) if tran else (m, n), ty, fa, orient)
    B, Bs = _operand(rng, (m, n), ty, fb, orient)
    zt = op.out_type(ty, ty)
    C, Cs = _operand(rng, (m, n), zt, "sparse", orient)
    M, Ms = _mask(rng, (m, n), mask, fa, orient)
    d = _desc(mask, flags, transpose0=tran)
    acc = _accum(zt, accum)
    kw = dict(C=C, mask=M, accum=acc, desc=d)
    if mode == "union":
        alpha, beta = TT.host(TT.scalar(2, ty, "cpu"))[()], \
            TT.host(TT.scalar(1, ty, "cpu"))[()]
        if ty.is_struct:
            alpha, beta = np.array([1, 0]), np.array([0, 1])
        got = gt.ewise_union(A, alpha, B, beta, op, **kw)
        want = TS.spec_ewise_union(Cs, Ms, acc, op, As, alpha, Bs, beta, d)
    else:
        got = getattr(gt, f"ewise_{mode}")(A, B, op, **kw)
        want = getattr(TS, f"spec_ewise_{mode}")(Cs, Ms, acc, op, As, Bs, d)
    _check(got, want)


def _run_rest(rng, op, ty, setting):
    fa, fb, orient, mask, flags, accum, tran = setting
    m, n = _shape(rng)
    acc = _accum(ty, accum)
    if op == "extract":
        A, As = _operand(rng, (n, m) if tran else (m, n), ty, fa, orient)
        I = rng.integers(0, m, int(rng.integers(1, m + 1))).tolist()
        J = rng.permutation(n)[:int(rng.integers(1, n + 1))].tolist()
        C, Cs = _operand(rng, (len(I), len(J)), ty, fb, orient)
        M, Ms = _mask(rng, (len(I), len(J)), mask, fb, orient)
        d = _desc(mask, flags, transpose0=tran)
        got = gt.extract(A, I, J, C=C, mask=M, accum=acc, desc=d)
        want = TS.spec_extract(Cs, Ms, acc, As, I, J, d)
    elif op in ("subassign", "assign"):
        C, Cs = _operand(rng, (m, n), ty, fa, orient)
        I = sorted(rng.permutation(m)[:int(rng.integers(1, m + 1))].tolist())
        J = rng.permutation(n)[:int(rng.integers(1, n + 1))].tolist()
        A, As = _operand(rng, (len(I), len(J)), ty, fb, orient)
        mshape = (len(I), len(J)) if op == "subassign" else (m, n)
        M, Ms = _mask(rng, mshape, mask, fb, orient)
        d = _desc(mask, flags)
        got = getattr(gt, op)(C, A, I, J, mask=M, accum=acc, desc=d)
        want = getattr(TS, f"spec_{op}")(Cs, Ms, acc, As, I, J, d)
    elif op == "kronecker":
        (p, q), (r, s) = rng.integers(2, 5, 2), rng.integers(2, 5, 2)
        A, As = _operand(rng, (q, p) if tran else (p, q), ty, fa, orient)
        B, Bs = _operand(rng, (r, s), ty, fb, orient)
        C, Cs = _operand(rng, (p * r, q * s), ty, "sparse", orient)
        M, Ms = _mask(rng, (p * r, q * s), mask, fa, orient)
        d = _desc(mask, flags, transpose0=tran)
        kop = gt.operators.LAND if ty.is_bool else gt.operators.TIMES
        got = gt.kronecker(A, B, kop, C=C, mask=M, accum=acc, desc=d)
        want = TS.spec_kron(Cs, Ms, acc, kop, As, Bs, d)
    elif op == "transpose":
        A, As = _operand(rng, (m, n) if tran else (n, m), ty, fa, orient)
        C, Cs = _operand(rng, (m, n), ty, fb, orient)
        M, Ms = _mask(rng, (m, n), mask, fb, orient)
        d = _desc(mask, flags, transpose0=tran)
        got = gt.transpose(A, C=C, mask=M, accum=acc, desc=d)
        want = TS.spec_transpose(Cs, Ms, acc, As, d)
    else:
        A, As = _operand(rng, (n, m) if tran else (m, n), ty, fa, orient)
        C, Cs = _operand(rng, (m, 1), ty, "bitmap", "col")
        C = _reclass(C, gt.Vector)
        M, Ms = _mask(rng, (m, 1), mask, "bitmap", "col")
        if M is not None:
            M = _reclass(M, gt.Vector)
        d = _desc(mask, flags, transpose0=tran)
        mon = gt.monoid.LOR if ty.is_bool else gt.monoid.PLUS
        got = gt.reduce(A, mon, C=C, mask=M, accum=acc, desc=d)
        want = TS.spec_reduce_vector(Cs, Ms, acc, mon, As, d)
    _check(got, want)


HYPOT = gt.binary_op(torch.hypot, "hypot", commutative=True)
TWICE_MINUS = gt.binary_op(lambda x, y: x * 2 - y, "twice_minus")
CLIP03 = gt.unary_op(lambda x: torch.clamp(x, 0, 3), "clip03")


def _run_user(rng, op, setting):
    if op == "hypot":
        _run_ewise(rng, "add", HYPOT, TT.FP32, setting)
    elif op == "twice_minus":
        _run_ewise(rng, "union", TWICE_MINUS, TT.INT16, setting)
    elif op == "gauss_ewise":
        gauss, add_mon, _ = gauss_demo.algebra()
        _run_ewise(rng, "add", add_mon.op, gauss, setting)
    elif op == "gauss_mxm":
        gauss, _, sr = gauss_demo.algebra()
        _run_mxm(rng, sr, gauss, setting, zt=gauss)
    elif op == "lse_mxm":
        _run_mxm(rng, semiring_demo.LSE_PLUS, TT.FP64, setting, rtol=1e-12)
    else:
        fa, fb, orient, mask, flags, accum, tran = setting
        m, n = _shape(rng)
        A, As = _operand(rng, (n, m) if tran else (m, n), TT.FP64, fa,
                         orient)
        C, Cs = _operand(rng, (m, n), TT.FP64, fb, orient)
        M, Ms = _mask(rng, (m, n), mask, fb, orient)
        d = _desc(mask, flags, transpose0=tran)
        acc = _accum(TT.FP64, accum)
        if op == "clip03_apply":
            got = gt.apply(A, CLIP03, C=C, mask=M, accum=acc, desc=d)
            want = TS.spec_apply(Cs, Ms, acc, CLIP03, As, d)
        else:
            got = gt.select(A, gt.operators.VALUEGT, 0.5, C=C, mask=M,
                            accum=acc, desc=d)
            want = TS.spec_select(Cs, Ms, acc, gt.operators.VALUEGT, As,
                                  0.5, d)
        _check(got, want)


def _run_bf16(rng, op, setting):
    ty = TT.BF16
    if op in ("ewise_add", "ewise_mult"):
        _run_ewise(rng, op[6:], gt.operators.PLUS if op == "ewise_add"
                   else gt.operators.TIMES, ty, setting)
    elif op == "mxm":
        _run_mxm(rng, gt.semiring.PLUS_TIMES, ty, setting)
    elif op in ("reduce", "transpose"):
        _run_rest(rng, op, ty, setting)
    else:
        fa, fb, orient, mask, flags, accum, tran = setting
        m, n = _shape(rng)
        A, As = _operand(rng, (m, n), ty, fa, orient)
        C, Cs = _operand(rng, (m, n), ty, fb, orient)
        M, Ms = _mask(rng, (m, n), mask, fb, orient)
        d = _desc(mask, flags)
        acc = _accum(ty, accum)
        got = gt.apply(A, gt.operators.AINV, C=C, mask=M, accum=acc, desc=d)
        _check(got, TS.spec_apply(Cs, Ms, acc, gt.operators.AINV, As, d))


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_op_layer_matches_spec(case):
    family, op, tname, setting = case
    rng = np.random.default_rng(CASES.index(case))
    if family == "mxm":
        _run_mxm(rng, getattr(gt.semiring, op), TT.lookup(f"GrB_{tname}"),
                 setting)
    elif family.startswith("ewise_"):
        _run_ewise(rng, family[6:], getattr(gt.operators, op),
                   TT.lookup(f"GrB_{tname}"), setting)
    elif family == "user":
        _run_user(rng, op, setting)
    elif family == "bf16":
        _run_bf16(rng, op, setting)
    else:
        _run_rest(rng, family, TT.lookup(f"GrB_{tname}"), setting)
