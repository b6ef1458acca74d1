"""The port's executable spec (graphblas_tpu_torch/spec/oracle.py) against
the JAX package's (graphblas_tpu/spec/oracle.py): each ``spec_*``
function gets the same (values, pattern) inputs, made from a numpy seed,
over FP64, INT16, UINT64, BOOL and FC64, with a mask, an accumulator and
a descriptor, and the two answers must agree: integers and bools
exactly, floats and complex within 1e-12 of the largest magnitude.

The documented differences are held against numpy instead:
* the JAX spec applies a 1-based positional multiply's callable to the
  already 1-based coordinate (FIRSTJ1 gives k + 2); the port's gives
  k + 1, as both libraries do;
* the JAX spec cannot take a struct type: its (m, n) pattern does not
  broadcast over the field axis; the port's Gauss-integer results are
  held against numpy's complex arithmetic.
"""

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.spec import oracle as JS
from graphblas_tpu_torch.spec import oracle as TS

M, K, N = 6, 5, 7
TYPES = ("FP64", "INT16", "UINT64", "BOOL", "FC64")
NP = {"FP64": np.float64, "INT16": np.int16, "UINT64": np.uint64,
      "BOOL": np.bool_, "FC64": np.complex128}


def _values(rng, shape, tname):
    if tname == "BOOL":
        return rng.random(shape) < 0.5
    if tname == "FC64":
        return (rng.integers(-4, 5, shape)
                + 1j * rng.integers(-4, 5, shape)).astype(np.complex128)
    if tname == "UINT64":
        return rng.integers(0, 9, shape).astype(np.uint64)
    if tname == "INT16":
        return rng.integers(-9, 10, shape).astype(np.int16)
    return rng.standard_normal(shape)


def _pair(rng, shape, tname, density=0.55):
    p = rng.random(shape) < density
    v = _values(rng, shape, tname)
    return np.where(p, v, np.zeros(1, v.dtype)), p


def _both(v, p):
    """The same inputs as a JAX SpecMat and a port SpecMat."""
    return JS.SpecMat(v.copy(), p.copy()), TS.SpecMat(v.copy(), p.copy())


def _ops(tname):
    """(JAX, port) names of the add-like op, the monoid's op and the
    semiring for a type."""
    if tname == "BOOL":
        return "LOR", "LOR", "LOR_LAND"
    return "PLUS", "PLUS", "PLUS_TIMES"


DESCS = [dict(), dict(replace=True), dict(mask_complement=True),
         dict(mask_structure=True, replace=True),
         dict(mask_complement=True, mask_structure=True)]


def _desc(i, **extra):
    kw = dict(DESCS[i % len(DESCS)], **extra)
    return gb.Descriptor(**kw), gt.Descriptor(**kw)


def _assert_same(js, ts, tname):
    if isinstance(js, JS.SpecMat):
        np.testing.assert_array_equal(np.asarray(js.pattern), ts.pattern)
        a = np.where(js.pattern, np.asarray(js.values), 0)
        b = np.where(ts.pattern, ts.values, 0)
    else:
        a, b = np.asarray(js), np.asarray(ts)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if tname in ("FP64", "FC64"):
        scale = max(1.0, float(np.abs(a).max(initial=0.0)))
        assert float(np.abs(a - b).max(initial=0.0)) <= 1e-12 * scale
    else:
        np.testing.assert_array_equal(a, b)


FUNCS = ("accum_mask", "mxm", "ewise_add", "ewise_mult", "ewise_union",
         "apply_unary", "apply_bind", "apply_index", "select",
         "reduce_vector", "reduce_scalar", "transpose", "extract",
         "subassign", "assign", "kron")


@pytest.mark.parametrize("tname", TYPES)
@pytest.mark.parametrize("func", FUNCS)
def test_spec_matches_jax_spec(func, tname):
    rng = np.random.default_rng(FUNCS.index(func) * 10 + TYPES.index(tname))
    addn, monn, srn = _ops(tname)
    addj, addt = getattr(gb.operators, addn), getattr(gt.operators, addn)
    monj, mont = getattr(gb.monoid, monn), getattr(gt.monoid, monn)
    srj, srt = getattr(gb.semiring, srn), getattr(gt.semiring, srn)
    i = FUNCS.index(func) + TYPES.index(tname)
    dj, dt = _desc(i)
    mj, mt = _both(*_pair(rng, (M, N), "INT16"))
    cj, ct = _both(*_pair(rng, (M, N), tname))
    aj, at = _both(*_pair(rng, (M, N), tname))
    bj, bt = _both(*_pair(rng, (M, N), tname))
    if func == "accum_mask":
        js = JS.spec_accum_mask(cj, mj, addj, aj, dj)
        ts = TS.spec_accum_mask(ct, mt, addt, at, dt)
    elif func == "mxm":
        aj, at = _both(*_pair(rng, (K, M), tname))
        bj, bt = _both(*_pair(rng, (K, N), tname))
        dj, dt = _desc(i, transpose0=True)
        js = JS.spec_mxm(cj, mj, addj, srj, aj, bj, dj)
        ts = TS.spec_mxm(ct, mt, addt, srt, at, bt, dt)
    elif func in ("ewise_add", "ewise_mult"):
        opn = "LAND" if tname == "BOOL" else "TIMES" if func == "ewise_add" \
            else "MINUS"
        jo, to = getattr(gb.operators, opn), getattr(gt.operators, opn)
        js = getattr(JS, f"spec_{func}")(cj, mj, addj, jo, aj, bj, dj)
        ts = getattr(TS, f"spec_{func}")(ct, mt, addt, to, at, bt, dt)
    elif func == "ewise_union":
        alpha, beta = (True, False) if tname == "BOOL" else (2, 3)
        opn = "LXOR" if tname == "BOOL" else "MINUS"
        js = JS.spec_ewise_union(cj, mj, addj, getattr(gb.operators, opn),
                                 aj, alpha, bj, beta, dj)
        ts = TS.spec_ewise_union(ct, mt, addt, getattr(gt.operators, opn),
                                 at, alpha, bt, beta, dt)
    elif func == "apply_unary":
        opn = "LNOT" if tname == "BOOL" else "AINV"
        js = JS.spec_apply(cj, mj, addj, getattr(gb.operators, opn), aj, dj)
        ts = TS.spec_apply(ct, mt, addt, getattr(gt.operators, opn), at, dt)
    elif func == "apply_bind":
        s = True if tname == "BOOL" else NP[tname](3)
        opn = "LAND" if tname == "BOOL" else "TIMES"
        js = JS.spec_apply(cj, mj, addj, getattr(gb.operators, opn), aj, dj,
                           bind=("second", s))
        ts = TS.spec_apply(ct, mt, addt, getattr(gt.operators, opn), at, dt,
                           bind=("second", s))
    elif func == "apply_index":
        cj, ct = _both(*_pair(rng, (M, N), "INT16"))
        js = JS.spec_apply(cj, mj, None, gb.operators.ROWINDEX, aj, dj,
                           thunk=2)
        ts = TS.spec_apply(ct, mt, None, gt.operators.ROWINDEX, at, dt,
                           thunk=2)
    elif func == "select":
        opn, th = ("VALUEEQ", True) if tname in ("BOOL", "FC64") else \
            ("VALUEGT", 1)
        js = JS.spec_select(cj, mj, addj, getattr(gb.operators, opn), aj,
                            th, dj)
        ts = TS.spec_select(ct, mt, addt, getattr(gt.operators, opn), at,
                            th, dt)
    elif func == "reduce_vector":
        cj, ct = _both(*_pair(rng, (M, 1), tname))
        mj, mt = _both(*_pair(rng, (M, 1), "INT16"))
        js = JS.spec_reduce_vector(cj, mj, addj, monj, aj, dj)
        ts = TS.spec_reduce_vector(ct, mt, addt, mont, at, dt)
    elif func == "reduce_scalar":
        init = True if tname == "BOOL" else NP[tname](5)
        js = JS.spec_reduce_scalar(monj, aj, addj, init)
        ts = TS.spec_reduce_scalar(mont, at, addt, init)
    elif func == "transpose":
        cj, ct = _both(*_pair(rng, (N, M), tname))
        mj, mt = _both(*_pair(rng, (N, M), "INT16"))
        js = JS.spec_transpose(cj, mj, addj, aj, dj)
        ts = TS.spec_transpose(ct, mt, addt, at, dt)
    elif func == "extract":
        I, J = [4, 0, 2], [6, 1, 1, 3]
        cj, ct = _both(*_pair(rng, (3, 4), tname))
        mj, mt = _both(*_pair(rng, (3, 4), "INT16"))
        js = JS.spec_extract(cj, mj, addj, aj, I, J, dj)
        ts = TS.spec_extract(ct, mt, addt, at, I, J, dt)
    elif func in ("subassign", "assign"):
        I, J = [5, 1, 3], [0, 6, 2, 4]
        aj, at = _both(*_pair(rng, (3, 4), tname))
        if func == "subassign":
            mj, mt = _both(*_pair(rng, (3, 4), "INT16"))
        js = getattr(JS, f"spec_{func}")(cj, mj, addj, aj, I, J, dj)
        ts = getattr(TS, f"spec_{func}")(ct, mt, addt, at, I, J, dt)
    else:
        aj, at = _both(*_pair(rng, (2, 3), tname))
        bj, bt = _both(*_pair(rng, (3, 2), tname))
        cj, ct = _both(*_pair(rng, (6, 6), tname))
        mj, mt = _both(*_pair(rng, (6, 6), "INT16"))
        opn = "LAND" if tname == "BOOL" else "TIMES"
        js = JS.spec_kron(cj, mj, addj, getattr(gb.operators, opn), aj, bj,
                          dj)
        ts = TS.spec_kron(ct, mt, addt, getattr(gt.operators, opn), at, bt,
                          dt)
    _assert_same(js, ts, tname)


@pytest.mark.parametrize("which", ["FIRSTI", "SECONDJ", "FIRSTJ"])
def test_positional_mxm_matches_jax_spec(which):
    """A positional multiply without the +1: the same coordinates in both
    specs."""
    rng = np.random.default_rng(7)
    sj = gb.make_semiring(gb.monoid.MIN, getattr(gb.operators, which))
    st = gt.make_semiring(gt.monoid.MIN, getattr(gt.operators, which))
    aj, at = _both(*_pair(rng, (M, K), "FP64"))
    bj, bt = _both(*_pair(rng, (K, N), "FP64"))
    js = JS.spec_mxm(JS.SpecMat.empty((M, N), np.int64), None, None, sj,
                     aj, bj)
    ts = TS.spec_mxm(TS.SpecMat.empty((M, N), np.int64), None, None, st,
                     at, bt)
    _assert_same(js, ts, "INT64")


@pytest.mark.parametrize("which", ["FIRSTI1", "FIRSTJ1", "SECONDJ1"])
def test_positional_plus_one_mxm(which):
    """The 1-based positional multiplies against numpy: min over k of the
    coordinate + 1 (documented difference: the JAX spec adds 1 twice)."""
    rng = np.random.default_rng(8)
    st = gt.make_semiring(gt.monoid.MIN, getattr(gt.operators, which))
    a, pa = _pair(rng, (M, K), "FP64")
    b, pb = _pair(rng, (K, N), "FP64")
    ts = TS.spec_mxm(TS.SpecMat.empty((M, N), np.int64), None, None, st,
                     TS.SpecMat(a, pa), TS.SpecMat(b, pb))
    live = pa[:, :, None] & pb[None, :, :]           # (i, k, j)
    ii, kk, jj = np.indices((M, K, N))
    coord = {"FIRSTI1": ii, "FIRSTJ1": kk, "SECONDJ1": jj}[which] + 1
    want = np.where(live, coord, np.iinfo(np.int64).max).min(axis=1)
    np.testing.assert_array_equal(ts.pattern, live.any(axis=1))
    np.testing.assert_array_equal(ts.values[ts.pattern],
                                  want[live.any(axis=1)])
    # the JAX spec's answer is the coordinate + 2
    sj = gb.make_semiring(gb.monoid.MIN, getattr(gb.operators, which))
    js = JS.spec_mxm(JS.SpecMat.empty((M, N), np.int64), None, None, sj,
                     JS.SpecMat(a, pa), JS.SpecMat(b, pb))
    np.testing.assert_array_equal(np.asarray(js.values)[ts.pattern],
                                  want[live.any(axis=1)] + 1)


@pytest.mark.parametrize("pos", ["POSITIONI1", "POSITIONJ"])
def test_positional_apply_matches_jax_spec(pos):
    rng = np.random.default_rng(9)
    aj, at = _both(*_pair(rng, (M, N), "INT16"))
    cj, ct = _both(*_pair(rng, (M, N), "INT16"))
    mj, mt = _both(*_pair(rng, (M, N), "INT16"))
    dj, dt = _desc(1)
    js = JS.spec_apply(cj, mj, None, getattr(gb.operators, pos), aj, dj)
    ts = TS.spec_apply(ct, mt, None, getattr(gt.operators, pos), at, dt)
    _assert_same(js, ts, "INT16")


def _gauss():
    from graphblas_tpu_torch.examples import gauss_demo
    return gauss_demo.algebra()


def _gauss_pair(rng, shape, density=0.6):
    p = rng.random(shape) < density
    v = np.stack([rng.integers(-3, 4, shape), rng.integers(-3, 4, shape)],
                 axis=-1)
    v[~p] = 0
    return v, p


@pytest.mark.parametrize("func", ["mxm", "ewise_add", "reduce_vector",
                                  "reduce_scalar", "kron", "extract"])
def test_gauss_struct_spec_matches_numpy(func):
    """The port's spec on the Gauss struct (field axis trailing the
    matrix axes) against numpy complex128: exact."""
    gauss, add_mon, sr = _gauss()
    rng = np.random.default_rng(10)
    a, pa = _gauss_pair(rng, (M, K))
    b, pb = _gauss_pair(rng, (K, N) if func == "mxm" else (M, K))
    A, B = TS.SpecMat(a, pa, gauss), TS.SpecMat(b, pb, gauss)
    cx = lambda v: v[..., 0] + 1j * v[..., 1]          # noqa: E731
    if func == "mxm":
        got = TS.spec_mxm(TS.SpecMat.empty((M, N), gauss), None, None, sr,
                          A, B)
        want = (cx(a) * pa) @ (cx(b) * pb)
        wpat = (pa.astype(int) @ pb.astype(int)) > 0
    elif func == "ewise_add":
        got = TS.spec_ewise_add(TS.SpecMat.empty((M, K), gauss), None, None,
                                add_mon.op, A, B)
        want, wpat = cx(a) * pa + cx(b) * pb, pa | pb
    elif func == "reduce_vector":
        got = TS.spec_reduce_vector(TS.SpecMat.empty((M, 1), gauss), None,
                                    None, add_mon, A)
        want = (cx(a) * pa).sum(axis=1, keepdims=True)
        wpat = pa.any(axis=1, keepdims=True)
    elif func == "reduce_scalar":
        s = TS.spec_reduce_scalar(add_mon, A)
        w = (cx(a) * pa).sum()
        assert (s[0], s[1]) == (w.real, w.imag)
        return
    elif func == "kron":
        got = TS.spec_kron(TS.SpecMat.empty((M * M, K * K), gauss), None,
                           None, sr.mult, A, B)
        want = np.kron(cx(a) * pa, cx(b) * pb)
        wpat = np.kron(pa, pb).astype(bool)
    else:
        I, J = [3, 0, 5], [4, 4, 1]
        got = TS.spec_extract(TS.SpecMat.empty((3, 3), gauss), None, None,
                              A, I, J)
        want, wpat = (cx(a) * pa)[np.ix_(I, J)], pa[np.ix_(I, J)]
    np.testing.assert_array_equal(got.pattern, wpat)
    assert got.values.shape == wpat.shape + (2,)
    np.testing.assert_array_equal(cx(got.values)[wpat], want[wpat])


def test_spec_cast_follows_port_cast():
    """_cast_np against the port's types.cast on the values the JAX spec
    rounds differently (the exact 64-bit maxima) and on wrapping."""
    import torch
    from graphblas_tpu_torch.core import types as TT
    x = np.array([2.0 ** 63, 1e30, -1e30, 2.0 ** 64, 9.3e18, -2.5, 2.5,
                  np.nan])
    for to in (TT.INT64, TT.UINT64, TT.INT32, TT.UINT16, TT.INT8, TT.BF16,
               TT.BOOL):
        want = TT.host(TT.cast(torch.from_numpy(x), to))
        np.testing.assert_array_equal(TS._cast_np(x, to), want)
    i = np.array([-1, 70000, -70000, 3], np.int64)
    for to in (TT.UINT16, TT.UINT32, TT.UINT64, TT.INT8, TT.BF16):
        want = TT.host(TT.cast(torch.from_numpy(i), to))
        np.testing.assert_array_equal(TS._cast_np(i, to), want)
