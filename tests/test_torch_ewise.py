"""Port parity: eWiseAdd / eWiseMult / eWiseUnion and the union merge
(graphblas_tpu_torch.ops.ewise, kernels.segment.union_merge) against
graphblas_tpu, and the complex types against its executable spec
(graphblas_tpu/spec/oracle.py).

Exact (bitwise on the dense values) for every type and arithmetic op;
transcendental ops within rtol 1e-6 (FP32) / 1e-14 (FP64), where XLA and
torch may round the last ulp differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.core import ops as JO
from graphblas_tpu.kernels import segment as JK
from graphblas_tpu.spec import oracle as SPEC
from graphblas_tpu_torch.core import ops as TO
from graphblas_tpu_torch.kernels import segment as TK
from torch_parity import (assert_same, cpu_default, dense_port,  # noqa: F401
                          to_port, xla_path)

pytestmark = pytest.mark.usefixtures("xla_path")

SHAPE = (24, 18)
TYPES = ["BOOL", "INT8", "INT32", "INT64", "UINT8", "UINT16", "UINT32",
         "UINT64", "FP32", "FP64", "FC32", "FC64"]


def _values(rng, n, dt):
    """``n`` values of numpy dtype ``dt`` over its range (small ints and
    zeros for DIV by zero; unsigned above the top bit; NaN and -0.0 for
    floats)."""
    dt = np.dtype(dt)
    if dt == np.bool_:
        return rng.random(n) < 0.5
    if dt.kind == "c":
        return (rng.standard_normal(n)
                + 1j * rng.standard_normal(n)).astype(dt)
    if dt.kind == "f":
        v = rng.standard_normal(n).astype(dt)
        v[::11] = np.nan
        v[1::13] = -0.0
        return v
    info = np.iinfo(dt)
    v = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    v[::5] = rng.integers(0, 4, v[::5].size).astype(dt)
    return v


def _sparse(rng, dt, which, density=0.3, shape=SHAPE):
    """A random matrix of dtype ``dt``: the pattern is fixed by ``which``
    (so the JAX package compiles its shape-specialised merges once a
    pattern), the values come from ``rng``."""
    m, n = shape
    k = max(1, int(m * n * density))
    flat = np.random.default_rng(100 + which).choice(m * n, k,
                                                     replace=False)
    return sps.csr_matrix((_values(rng, k, dt), (flat // n, flat % n)),
                          shape=shape)


def _pair(S, fmt="sparse", orient="row"):
    """(JAX Matrix, port Matrix) of a scipy matrix in ``fmt``/``orient``
    (a FULL operand is S made dense, zeros included)."""
    if fmt == "full":
        A = gb.Matrix.from_dense(np.asarray(S.todense()))
        A = A.to_format(gb.FULL, orient)
    else:
        A = gb.Matrix.from_scipy(S, orient=orient).to_format(fmt, orient)
    return A, to_port(A)


def _op_pair(name):
    return getattr(JO, name), getattr(TO, name)


# each mode's op for each class of type (each distinct op costs the JAX
# package a compile of its finisher, so the op sweep is one type's:
# test_ewise_ops); complex TIMES and DIV are in the oracle test
MODE_OPS = {"bool": ("LOR", "LAND", "LXOR"),
            "int": ("PLUS", "TIMES", "MINUS"),
            "float": ("PLUS", "TIMES", "MINUS"),
            "complex": ("PLUS", "MINUS", "PLUS")}
MODES = ("add", "mult", "union")


def _kind(name):
    ty = gt.types.lookup(f"G{'x' if name.startswith('FC') else 'r'}B_"
                         f"{name}")
    if ty.is_bool:
        return ty, "bool"
    if ty.is_complex:
        return ty, "complex"
    return ty, "float" if ty.is_float else "int"


def _run(mode, Aj, Bj, At, Bt, jop, top, **kw):
    if mode == "union":
        return (gb.ewise_union(Aj, 3, Bj, 1, jop, **kw),
                gt.ewise_union(At, 3, Bt, 1, top, **kw))
    return (getattr(gb, f"ewise_{mode}")(Aj, Bj, jop, **kw),
            getattr(gt, f"ewise_{mode}")(At, Bt, top, **kw))


def _spec(mode, jop, Aj, Bj, zt):
    """The executable spec's C = A op B (graphblas_tpu/spec/oracle.py)."""
    a, b = SPEC.SpecMat.from_gb(Aj), SPEC.SpecMat.from_gb(Bj)
    C0 = SPEC.SpecMat.empty(a.shape, zt)
    if mode == "union":
        return SPEC.spec_ewise_union(C0, None, None, jop, a, 3, b, 1)
    return getattr(SPEC, f"spec_ewise_{mode}")(C0, None, None, jop, a, b)


def _assert_spec(spec, Ct):
    vt, pt = dense_port(Ct)
    np.testing.assert_array_equal(pt, spec.pattern)
    assert vt.tobytes() == np.where(pt, spec.values, 0).astype(
        vt.dtype).tobytes()


@pytest.mark.parametrize("tname", TYPES)
def test_ewise_types(tname):
    """Every type on the sparse (union-merge) path, bitwise: ewise_add
    against the JAX package, then ewise_mult or ewise_union in turn (each
    type class has both) against its executable spec."""
    ty, kind = _kind(tname)
    i = TYPES.index(tname)
    rng = np.random.default_rng(i)
    Aj, At = _pair(_sparse(rng, ty.np_dtype, 0))
    Bj, Bt = _pair(_sparse(rng, ty.np_dtype, 1))
    Cj, Ct = _run("add", Aj, Bj, At, Bt, *_op_pair(MODE_OPS[kind][0]))
    assert Ct.fmt == "sparse" and Ct.dtype.name == Cj.dtype.name
    assert_same(Cj, Ct)
    mode = MODES[1 + i % 2]
    jop, top = _op_pair(MODE_OPS[kind][MODES.index(mode)])
    Ct = (gt.ewise_union(At, 3, Bt, 1, top) if mode == "union"
          else gt.ewise_mult(At, Bt, top))
    assert Ct.fmt == "sparse"
    _assert_spec(_spec(mode, jop, Aj, Bj, Ct.dtype.np_dtype), Ct)


@pytest.mark.parametrize("name", ["MINUS", "DIV", "RDIV", "MIN", "MAX",
                                  "BOR"])
def test_ewise_ops(name):
    """The op sweep on UINT64 (values over the whole range, 2^63 and up
    included; divisors 0): ewise_add, bitwise."""
    rng = np.random.default_rng(20)
    Aj, At = _pair(_sparse(rng, np.uint64, 0))
    Bj, Bt = _pair(_sparse(rng, np.uint64, 1))
    assert_same(*_run("add", Aj, Bj, At, Bt, *_op_pair(name)))


FORMATS = [("sparse", "sparse"), ("hypersparse", "sparse"),
           ("sparse", "bitmap"), ("bitmap", "full"), ("full", "full"),
           ("hypersparse", "hypersparse")]


@pytest.mark.parametrize("fa,fb", FORMATS)
def test_ewise_formats(fa, fb):
    """Storage format pairs (the dense path where one is bitmap or full),
    A by row or by column in turn (B by row); each case one mode in
    turn."""
    i = FORMATS.index((fa, fb))
    orient = ("row", "col")[i % 2]
    mode, name = (("add", "PLUS"), ("mult", "TIMES"),
                  ("union", "MINUS"))[i % 3]
    fa, fb = (f.replace("hypersparse", "hyper") for f in (fa, fb))
    rng = np.random.default_rng(7)
    Aj, At = _pair(_sparse(rng, np.float64, 0), fa, orient)
    Bj, Bt = _pair(_sparse(rng, np.float64, 1), fb)
    Cj, Ct = _run(mode, Aj, Bj, At, Bt, *_op_pair(name))
    assert Ct.fmt == Cj.fmt
    assert_same(Cj, Ct)


@pytest.mark.parametrize("name,dense,orient", [
    ("FIRSTI1", False, "row"), ("SECONDJ", False, "col"),
    ("FIRSTI1", True, "col"), ("SECONDJ", True, "row")])
def test_ewise_positional(name, dense, orient):
    """Positional ops read the entry's (i, j) on both paths (the sparse
    one by ewise_add, the dense one by ewise_mult)."""
    rng = np.random.default_rng(8)
    Aj, At = _pair(_sparse(rng, np.float32, 0), "bitmap" if dense else
                   "sparse", orient)
    Bj, Bt = _pair(_sparse(rng, np.float32, 1), orient=orient)
    Cj, Ct = _run("mult" if dense else "add", Aj, Bj, At, Bt,
                  *_op_pair(name))
    assert Ct.dtype.name == "GrB_INT64"
    assert_same(Cj, Ct)


def test_ewise_empty_operands():
    rng = np.random.default_rng(9)
    E = sps.csr_matrix(SHAPE, dtype=np.int32)
    Ej, Et = _pair(E)
    Aj, At = _pair(_sparse(rng, np.int32, 0))
    for mode, (X, Y) in zip(MODES, (((Ej, Et), (Aj, At)),
                                    ((Aj, At), (Ej, Et)),
                                    ((Ej, Et), (Ej, Et)))):
        Cj, Ct = _run(mode, X[0], Y[0], X[1], Y[1], *_op_pair("PLUS"))
        assert Ct.nvals == Cj.nvals
        assert_same(Cj, Ct)


DESCS = {"null": gb.descriptor.NULL, "RSC": gb.descriptor.RSC,
         "T0": gb.descriptor.T0, "T1": gb.descriptor.T1}


@pytest.mark.parametrize("dname,mask_fmt", [
    ("null", "sparse"), ("RSC", "sparse"), ("T0", "bitmap"),
    ("T1", "bitmap")])
def test_ewise_mask_accum_replace(dname, mask_fmt):
    """C<M> = accum(C, A op B) with replace, complement, structure and the
    two transposes (the transposed operand is made SHAPE[::-1]), against
    the executable spec (spec_accum_mask), and the first case against the
    JAX package too: each case one mode in turn, exact."""
    rng = np.random.default_rng(10)
    jd = DESCS[dname]
    i = list(DESCS).index(dname)
    Aj, At = _pair(_sparse(rng, np.int64, 0, 0.3,
                           SHAPE[::-1] if jd.transpose0 else SHAPE))
    Bj, Bt = _pair(_sparse(rng, np.int64, 1, 0.3,
                           SHAPE[::-1] if jd.transpose1 else SHAPE))
    Mj, Mt = _pair(_sparse(rng, np.int64, 3, 0.4), mask_fmt)
    Cj0, Ct0 = _pair(_sparse(rng, np.int64, 2))
    td = gt.Descriptor(**{f: getattr(jd, f) for f in (
        "replace", "mask_complement", "mask_structure", "transpose0",
        "transpose1")})
    mode, name, acc = (("add", "PLUS", "MINUS"), ("mult", "MAX", None),
                       ("union", "TIMES", "PLUS"))[i % 3]
    ja, ta = _op_pair(acc) if acc else (None, None)
    jop, top = _op_pair(name)
    a, b, m, c = (SPEC.SpecMat.from_gb(X) for X in (Aj, Bj, Mj, Cj0))
    if mode == "union":
        spec = SPEC.spec_ewise_union(c, m, ja, jop, a, 2, b, 5, jd)
        Ct = gt.ewise_union(At, 2, Bt, 5, top, C=Ct0, mask=Mt, accum=ta,
                            desc=td)
    else:
        spec = getattr(SPEC, f"spec_ewise_{mode}")(c, m, ja, jop, a, b, jd)
        Ct = getattr(gt, f"ewise_{mode}")(At, Bt, top, C=Ct0, mask=Mt,
                                          accum=ta, desc=td)
    assert Ct is Ct0
    _assert_spec(spec, Ct)
    if i == 0:
        Cj = getattr(gb, f"ewise_{mode}")(Aj, Bj, jop, C=Cj0, mask=Mj,
                                          accum=ja, desc=jd)
        assert_same(Cj, Ct)


@pytest.mark.parametrize("name,dt", [
    ("POW", np.float32), ("ATAN2", np.float64), ("HYPOT", np.float32),
    ("FMOD", np.float64), ("REMAINDER", np.float32),
    ("COPYSIGN", np.float64)])
def test_ewise_transcendental(name, dt):
    """Float-math ops: same pattern, values within rtol 1e-6 (FP32) or
    1e-14 (FP64); FMOD and REMAINDER (x - y rint(x / y), whose rounding
    XLA may fuse) also within that share of the operands' largest
    magnitude, as their results cancel."""
    rng = np.random.default_rng(11)
    Aj, At = _pair(abs(_sparse(rng, dt, 0)) if name == "POW"
                   else _sparse(rng, dt, 0))
    Bj, Bt = _pair(_sparse(rng, dt, 1))
    Cj, Ct = _run("add", Aj, Bj, At, Bt, *_op_pair(name))
    vj, pj = (np.asarray(x) for x in Cj.to_dense_pair())
    vt, pt = dense_port(Ct)
    np.testing.assert_array_equal(pj, pt)
    rtol = 1e-6 if dt == np.float32 else 1e-14
    scale = float(np.nanmax(np.abs(np.concatenate(
        [dense_port(At)[0].ravel(), dense_port(Bt)[0].ravel()]))))
    np.testing.assert_allclose(
        vt[pt], vj[pj], equal_nan=True, rtol=rtol,
        atol=rtol * scale if name in ("FMOD", "REMAINDER") else 0)


@pytest.mark.parametrize("tname", ["FC32", "FC64"])
def test_ewise_complex_matches_oracle(tname):
    """The complex types against the executable spec (the JAX package has
    no complex execution test): add, mult and union; PLUS and MINUS
    bitwise, TIMES and DIV within rtol 1e-6 (FC32) / 1e-14 (FC64): their
    rounding differs in the last ulp between XLA, numpy and torch."""
    ty, _ = _kind(tname)
    rng = np.random.default_rng(12)
    SA, SB = _sparse(rng, ty.np_dtype, 0), _sparse(rng, ty.np_dtype, 1)
    Aj, At = _pair(SA)
    Bj, Bt = _pair(SB)
    a, b = SPEC.SpecMat.from_gb(Aj), SPEC.SpecMat.from_gb(Bj)
    C0 = SPEC.SpecMat.empty(SHAPE, ty.np_dtype)
    for name in ("PLUS", "MINUS", "TIMES", "DIV"):
        jop, top = _op_pair(name)
        for mode, spec in (("add", SPEC.spec_ewise_add(C0, None, None, jop,
                                                       a, b)),
                           ("mult", SPEC.spec_ewise_mult(C0, None, None,
                                                         jop, a, b)),
                           ("union", SPEC.spec_ewise_union(
                               C0, None, None, jop, a, 3, b, 1))):
            Ct = (gt.ewise_union(At, 3, Bt, 1, top) if mode == "union"
                  else getattr(gt, f"ewise_{mode}")(At, Bt, top))
            vt, pt = dense_port(Ct)
            np.testing.assert_array_equal(pt, spec.pattern)
            if name in ("PLUS", "MINUS"):
                np.testing.assert_array_equal(vt[pt], spec.values[pt])
            else:
                np.testing.assert_allclose(
                    vt[pt], spec.values[pt], atol=0,
                    rtol=1e-6 if tname == "FC32" else 1e-14)


def test_ewise_vectors():
    """Two Vectors give a Vector, on both paths (BITMAP u or SPARSE u,
    SPARSE v): MAX where both are present (NaN loses), the present value
    elsewhere, as numpy computes it."""
    rng = np.random.default_rng(13)
    x, y = _values(rng, 40, np.float64), _values(rng, 40, np.float64)
    p, q = rng.random(40) < 0.4, rng.random(40) < 0.6
    vt = gt.Vector.from_coo(np.flatnonzero(q), y[q], 40)
    want = np.where(p & q, np.fmax(x, y), np.where(p, x, y))
    for ut in (gt.Vector.from_dense_masked(x, p),
               gt.Vector.from_coo(np.flatnonzero(p), x[p], 40)):
        wt = gt.ewise_add(ut, vt, gt.operators.MAX)
        assert isinstance(wt, gt.Vector)
        wv, wp = (t.numpy() for t in wt.to_dense_1d())
        np.testing.assert_array_equal(wp, p | q)
        np.testing.assert_array_equal(wv[wp], want[p | q])


# ---------------------------------------------------------------------------
# the union merge itself
# ---------------------------------------------------------------------------

MERGE_TYPES = [np.float32, np.float64, np.int64, np.uint16, np.uint64,
               np.complex64, np.complex128, "f8x2"]


def _merge_inputs(rng, dt):
    ka = np.unique(rng.integers(0, 400, 150)).astype(np.int64)
    kb = np.unique(rng.integers(0, 400, 180)).astype(np.int64)
    if dt == "f8x2":           # a (k, 2) payload: struct-typed values
        return ka, rng.standard_normal((ka.size, 2)), kb, \
            rng.standard_normal((kb.size, 2))
    va, vb = _values(rng, ka.size, dt), _values(rng, kb.size, dt)
    if np.dtype(dt) == np.float32:       # a NaN with its own payload bits
        va.view(np.int32)[2] = 0x7FC00123
    return ka, va, kb, vb


@pytest.mark.parametrize("dt", MERGE_TYPES, ids=str)
def test_union_merge_matches(dt):
    """Keys, both sides' values (bitwise: NaN payloads and -0.0 survive,
    complex128 and the (k, 2) payload too) and presence equal the JAX
    package's (empty sides: test_ewise_empty_operands)."""
    ka, va, kb, vb = _merge_inputs(np.random.default_rng(14), dt)
    want = JK.union_merge(*map(jnp.asarray, (ka, va, kb, vb)), key_bound=400)
    got = TK.union_merge(*map(torch.from_numpy, (ka, va, kb, vb)))
    for w, g in zip(want, got):
        w, g = np.asarray(w), g.numpy()
        assert w.dtype == g.dtype and w.shape == g.shape
        assert w.tobytes() == g.tobytes()