"""Port parity: types, operators, monoids, semirings, segmented reductions
(graphblas_tpu_torch.core / kernels.segment against graphblas_tpu)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphblas_tpu as gb
from graphblas_tpu.core import monoid as JM
from graphblas_tpu.core import ops as JO
from graphblas_tpu.core import types as JT
from graphblas_tpu.kernels import segment as JK
from graphblas_tpu_torch.core import monoid as TM
from graphblas_tpu_torch.core import ops as TO
from graphblas_tpu_torch.core import semiring as TS
from graphblas_tpu_torch.core import types as TT
from graphblas_tpu_torch.kernels import segment as TK
from torch_parity import cpu_default  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", [t.name for t in JT.ALL_TYPES])
def test_type_table_matches(name):
    jt, tt = JT.lookup(name), TT.lookup(name)
    assert tt.np_dtype == jt.np_dtype
    assert torch.empty(0, dtype=tt.torch_dtype).numpy().dtype == jt.np_dtype
    assert TT.lookup(tt.torch_dtype) is tt
    assert (tt.is_float, tt.is_integer, tt.is_bool, tt.is_complex) == \
        (jt.is_float, jt.is_integer, jt.is_bool, jt.is_complex)


UNSIGNED = [TT.UINT16, TT.UINT32, TT.UINT64]


def _unsigned_pair(rng, ty):
    """Random values of ``ty`` over its whole range, with 0, 1, the top
    bit set, the maximum, and (UINT64) values either side of 2^63."""
    dt = ty.np_dtype
    top = np.iinfo(dt).max
    a = rng.integers(0, top, 256, dtype=dt, endpoint=True)
    b = rng.integers(0, top, 256, dtype=dt, endpoint=True)
    half = dt.type(1) << dt.type(8 * dt.itemsize - 1)
    a[:8] = [0, 1, top, half, half + dt.type(1), top, 7, half - dt.type(1)]
    b[:8] = [0, 0, 1, top, half, half - dt.type(1), 0, half + dt.type(3)]
    b[8::9] = 0
    b[9::11] = rng.integers(1, 4, b[9::11].size, dtype=dt)
    return a, b


def _jax_op(name, *arrs):
    return np.asarray(getattr(JO, name).fn(*map(jnp.asarray, arrs)))


def _port_op(name, *arrs):
    return getattr(TO, name).fn(*map(torch.from_numpy, arrs)).numpy()


@pytest.mark.parametrize("ty", UNSIGNED, ids=lambda t: t.name)
def test_unsigned_arithmetic_wraps(ty):
    """+ - x and AINV wrap at 2^w through the carriers: equal to numpy's
    wrapping arithmetic and to the JAX package, bitwise."""
    a, b = _unsigned_pair(np.random.default_rng(40), ty)
    with np.errstate(over="ignore"):
        want = {"PLUS": a + b, "MINUS": a - b, "RMINUS": b - a,
                "TIMES": a * b}
    for name, w in want.items():
        got = _port_op(name, a, b)
        assert got.dtype == ty.np_dtype
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, _jax_op(name, a, b))
    np.testing.assert_array_equal(_port_op("AINV", a), _jax_op("AINV", a))
    e = (b % 60).astype(ty.np_dtype)
    np.testing.assert_array_equal(_port_op("POW", a, e),
                                  _jax_op("POW", a, e))


@pytest.mark.parametrize("ty", UNSIGNED, ids=lambda t: t.name)
def test_unsigned_order(ty):
    """MIN/MAX and the comparators order values with the top bit set
    (UINT64 above 2^63) after the others."""
    a, b = _unsigned_pair(np.random.default_rng(41), ty)
    for name, w in (("MIN", np.minimum(a, b)), ("MAX", np.maximum(a, b)),
                    ("LT", a < b), ("GE", a >= b), ("GT", a > b),
                    ("LE", a <= b), ("ISLT", (a < b).astype(a.dtype)),
                    ("EQ", a == b)):
        got = _port_op(name, a, b)
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(got, _jax_op(name, a, b))


@pytest.mark.parametrize("ty", UNSIGNED, ids=lambda t: t.name)
def test_unsigned_division(ty):
    """Unsigned division, divisors with the top bit set included; x / 0 is
    UINT_MAX and 0 / 0 is 0 (GB_idiv), as in the JAX package."""
    a, b = _unsigned_pair(np.random.default_rng(42), ty)
    top = int(np.iinfo(ty.np_dtype).max)
    want = np.array([0 if y == 0 and x == 0 else top if y == 0
                     else x // y for x, y in zip(a.tolist(), b.tolist())],
                    ty.np_dtype)
    for name, x, y in (("DIV", a, b), ("RDIV", b, a)):
        got = _port_op(name, x, y)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, _jax_op(name, x, y))
    np.testing.assert_array_equal(_port_op("MINV", b), _jax_op("MINV", b))


@pytest.mark.parametrize("ty", UNSIGNED, ids=lambda t: t.name)
def test_unsigned_bitwise_and_sort_order(ty):
    """Bitwise ops and BNOT through the signed views; order_key sorts the
    carriers in unsigned order."""
    a, b = _unsigned_pair(np.random.default_rng(43), ty)
    for name in ("BOR", "BAND", "BXOR", "BXNOR"):
        np.testing.assert_array_equal(_port_op(name, a, b),
                                      _jax_op(name, a, b))
    np.testing.assert_array_equal(_port_op("BNOT", a), _jax_op("BNOT", a))
    s = (b % 40).astype(np.int64) - 20
    np.testing.assert_array_equal(_port_op("BSHIFT", a, s),
                                  _jax_op("BSHIFT", a, s))
    c = TT.carry(torch.from_numpy(a))
    k, _ = torch.sort(TT.order_key(c, c.dtype if ty is not TT.UINT64
                                   else torch.uint64))
    got = TT.uncarry(TT.order_key(k, torch.uint64 if ty is TT.UINT64
                                  else k.dtype), ty.torch_dtype)
    np.testing.assert_array_equal(got.numpy(), np.sort(a))


def _bitwise_segments(a, seg, n, mon):
    """numpy reference of BOR / BXNOR per segment (identity 0 / all
    bits): a k-term BXNOR is the XOR of the terms, negated for even k."""
    dt = a.dtype
    out = np.full(n, 0 if mon == "BOR" else np.iinfo(dt).max, dt)
    for g in np.unique(seg):
        v = a[seg == g]
        if mon == "BOR":
            out[g] = np.bitwise_or.reduce(v)
        else:
            x = np.bitwise_xor.reduce(v)
            out[g] = x if v.size % 2 else ~x
    return out


@pytest.mark.parametrize("ty", UNSIGNED, ids=lambda t: t.name)
@pytest.mark.parametrize("mon", ["PLUS", "TIMES", "MIN", "MAX", "ANY",
                                 "LOR", "LXOR", "BOR", "BXNOR"])
def test_unsigned_reductions(ty, mon):
    """segment_reduce and full_reduce on the unsigned types equal the JAX
    package's (whose full PLUS/TIMES promote to 64 bits: compared after
    the cast back to the type); BOR and BXNOR (the generic scan) equal a
    numpy reduction."""
    rng = np.random.default_rng(44)
    a, _ = _unsigned_pair(rng, ty)
    seg = np.sort(rng.integers(0, 40, a.size)).astype(np.int32)
    tm = getattr(TM, mon)
    got = TK.segment_reduce(torch.from_numpy(a), torch.from_numpy(seg), 45,
                            tm).numpy()
    full = TK.full_reduce(torch.from_numpy(a), tm).numpy()
    assert got.dtype == full.dtype == ty.np_dtype
    if mon in ("BOR", "BXNOR"):
        np.testing.assert_array_equal(got, _bitwise_segments(a, seg, 45,
                                                             mon))
        np.testing.assert_array_equal(
            full, _bitwise_segments(a, np.zeros_like(seg), 1, mon)[0])
        return
    jm = getattr(JM, mon)
    np.testing.assert_array_equal(
        got, np.asarray(JK.segment_reduce(jnp.asarray(a), jnp.asarray(seg),
                                          45, jm)))
    np.testing.assert_array_equal(
        full,
        np.asarray(JK.full_reduce(jnp.asarray(a), jm)).astype(ty.np_dtype))


def test_cast_clamp_bound():
    """float -> INT64 / UINT64 saturates at the type's exact maximum, the
    reference's GB_cast_to_int64_t / uint64_t (GB_casting.h): 2^63 and
    2^64 are not representable, so a clamp to float(max) would overflow.
    UINT64 -> float rounds values above 2^63 once.  Reference values, not
    the JAX package's."""
    x = torch.tensor([2.0 ** 63, 1e30, -1e30, 2.0 ** 64, 1.8e19, 9.3e18,
                      -2.0 ** 63, 2.5, float("nan")], dtype=torch.float64)
    i64 = np.iinfo(np.int64)
    np.testing.assert_array_equal(
        TT.cast(x, TT.INT64).numpy(),
        [i64.max, i64.max, i64.min, i64.max, i64.max, i64.max,
         i64.min, 2, 0])
    np.testing.assert_array_equal(
        TT.cast(x, TT.UINT64).numpy(),
        np.array([2 ** 63, 2 ** 64 - 1, 0, 2 ** 64 - 1, 18 * 10 ** 18,
                  93 * 10 ** 17, 0, 2, 0], np.uint64))
    f32 = torch.tensor([3e9, -3e9, 5e9], dtype=torch.float32)
    np.testing.assert_array_equal(TT.cast(f32, TT.INT32).numpy(),
                                  [2 ** 31 - 1, -2 ** 31, 2 ** 31 - 1])
    np.testing.assert_array_equal(TT.cast(f32, TT.UINT32).numpy(),
                                  np.array([3 * 10 ** 9, 0, 2 ** 32 - 1],
                                           np.uint32))
    u = np.array([2 ** 64 - 1, 2 ** 63, 12345678901234567891, 3],
                 np.uint64)
    np.testing.assert_array_equal(
        TT.cast(torch.from_numpy(u), TT.FP64).numpy(), u.astype(np.float64))
    np.testing.assert_array_equal(
        TT.cast(torch.from_numpy(u), TT.INT64).numpy(), u.view(np.int64))


def _np_pair(rng, kind):
    if kind == "int":
        a = rng.integers(-9, 10, 64).astype(np.int32)
        b = rng.integers(-3, 4, 64).astype(np.int32)     # zeros included
    else:
        a = rng.standard_normal(64).astype(np.float64)
        b = rng.standard_normal(64).astype(np.float64)
        a[::7] = np.nan
    return a, b


BINARY = [("PLUS", "float"), ("MINUS", "int"), ("TIMES", "float"),
          ("DIV", "int"), ("DIV", "float"), ("MIN", "float"),
          ("MAX", "float"), ("MIN", "int"), ("EQ", "int"), ("LT", "float"),
          ("LOR", "int"), ("LAND", "float"), ("BOR", "int"),
          ("BSHIFT", "int"), ("ISGT", "int"), ("FIRST", "float"),
          ("PAIR", "int"), ("RMINUS", "float"), ("RDIV", "int")]


@pytest.mark.parametrize("name,kind", BINARY)
def test_binary_ops_match(name, kind):
    """Exact for int/bool; floats compare bit-equal too (same IEEE op)."""
    rng = np.random.default_rng(3)
    a, b = _np_pair(rng, kind)
    want = np.asarray(getattr(JO, name).fn(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(TO, name).fn(torch.from_numpy(a), torch.from_numpy(b))
    got = got.numpy()
    if want.dtype == np.bool_ or got.dtype == np.bool_:
        np.testing.assert_array_equal(got.astype(bool), want.astype(bool))
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype))


UNARY = ["AINV", "ABS", "MINV", "LNOT", "ONE", "SQRT", "EXP", "SIGNUM",
         "FLOOR", "ISNAN"]


@pytest.mark.parametrize("name", UNARY)
def test_unary_ops_match(name):
    """rtol 1e-15: transcendental functions may differ in the last ulp
    between XLA and torch."""
    x = np.array([-2.5, -1.0, 0.0, 0.5, 3.0, np.nan], np.float64)
    xi = np.array([-3, -1, 0, 1, 4, 7], np.int32)
    for arr in ((x, xi) if name in ("AINV", "ABS", "MINV", "LNOT", "ONE",
                                    "SIGNUM") else (x,)):
        want = np.asarray(getattr(JO, name).fn(jnp.asarray(arr)))
        got = getattr(TO, name).fn(torch.from_numpy(arr)).numpy()
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), rtol=1e-15,
                                   equal_nan=True)


@pytest.mark.parametrize("mon", ["PLUS", "TIMES", "MIN", "MAX", "ANY",
                                 "LOR", "LAND", "LXOR", "BOR", "BAND"])
def test_monoid_identity_terminal(mon):
    jm, tm = getattr(JM, mon), getattr(TM, mon)
    for dt in (np.float32, np.float64, np.int32, np.int64, np.bool_):
        if mon.startswith("B") and dt in (np.float32, np.float64, np.bool_):
            continue
        assert tm.identity_for(dt) == jm.identity_for(dt)
        assert tm.terminal_for(dt) == jm.terminal_for(dt)


def test_named_semirings():
    for name in ("PLUS_TIMES", "MIN_PLUS", "MAX_TIMES", "LOR_LAND",
                 "MIN_FIRSTJ", "PLUS_PAIR", "MIN_SECONDI", "ANY_PAIR"):
        s = getattr(TS, name)
        assert s.name == name
        assert s.add.op.name == getattr(gb.semiring, name).add.op.name
        assert s.mult.name == getattr(gb.semiring, name).mult.name


def test_cast_matches():
    """Float -> int rounds to nearest, NaN -> 0, clamps (GB_casting.h)."""
    x = np.array([-1e12, -2.5, -0.5, 0.5, 1.5, 2.7, np.nan, 1e12])
    for ty in ("GrB_INT8", "GrB_INT32", "GrB_BOOL", "GrB_FP32"):
        want = np.asarray(JT.cast(jnp.asarray(x), JT.lookup(ty)))
        got = TT.cast(torch.from_numpy(x), TT.lookup(ty)).numpy()
        np.testing.assert_array_equal(got, want)


SEG_MONOIDS = ["PLUS", "TIMES", "MIN", "MAX", "LOR", "LAND", "LXOR", "ANY"]


@pytest.mark.parametrize("mon", SEG_MONOIDS + ["user"])
def test_segment_reduce_matches(mon):
    """Exact on int32 for every monoid, including a user monoid (the
    generic segmented scan) and empty segments (identity)."""
    rng = np.random.default_rng(5)
    seg = np.sort(rng.integers(0, 40, 300)).astype(np.int32)
    vals = rng.integers(-4, 5, 300).astype(np.int32)
    if mon == "user":
        jm = JM.monoid(JO.binary_op(lambda a, b: a + b, "user_plus"), 0)
        tm = TM.monoid(TO.binary_op(lambda a, b: a + b, "user_plus"), 0)
    else:
        jm, tm = getattr(JM, mon), getattr(TM, mon)
    want = np.asarray(JK.segment_reduce(jnp.asarray(vals), jnp.asarray(seg),
                                        45, jm))
    got = TK.segment_reduce(torch.from_numpy(vals), torch.from_numpy(seg),
                            45, tm).numpy()
    np.testing.assert_array_equal(got, want)
    fw = np.asarray(JK.full_reduce(jnp.asarray(vals), jm))
    fg = TK.full_reduce(torch.from_numpy(vals), tm).numpy()
    np.testing.assert_array_equal(fg, fw)


def test_segment_primitives_match():
    rng = np.random.default_rng(6)
    counts = rng.integers(0, 4, 50)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    nnz = int(indptr[-1])
    np.testing.assert_array_equal(
        TK.expand_rowids(torch.from_numpy(indptr), nnz, 50).numpy(),
        np.asarray(JK.expand_rowids(jnp.asarray(indptr), nnz, 50)))
    ids = np.sort(rng.integers(0, 30, 200)).astype(np.int32)
    np.testing.assert_array_equal(
        TK.indptr_from_sorted(torch.from_numpy(ids), 30).numpy(),
        np.asarray(JK.indptr_from_sorted(jnp.asarray(ids), 30)))
    keys = np.unique(rng.integers(0, 1000, 100)).astype(np.int64)
    q = rng.integers(-5, 1005, 80).astype(np.int64)
    fj, pj = JK.lookup_sorted(jnp.asarray(keys), jnp.asarray(q))
    ft, pt = TK.lookup_sorted(torch.from_numpy(keys), torch.from_numpy(q))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(pt.numpy()[ft.numpy()],
                                  np.asarray(pj)[np.asarray(fj)])
    sk = np.sort(rng.integers(0, 20, 60)).astype(np.int64)
    gj, nj = JK.group_ids(jnp.asarray(sk))
    gt_, nt = TK.group_ids(torch.from_numpy(sk))
    assert nj == nt
    np.testing.assert_array_equal(gt_.numpy(), np.asarray(gj))
    mask = rng.random(60) < 0.5
    cj, (aj,) = JK.compact(jnp.asarray(mask), jnp.asarray(sk))
    ct, (at,) = TK.compact(torch.from_numpy(mask), torch.from_numpy(sk))
    assert cj == ct
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))


def test_import_brings_no_jax():
    """The port imports torch, numpy and scipy only: no JAX module that
    was not loaded before the import."""
    code = ("import sys; before = set(sys.modules); "
            "import graphblas_tpu_torch, graphblas_tpu_torch.algorithms, "
            "graphblas_tpu_torch.entry, graphblas_tpu_torch.interop, "
            "graphblas_tpu_torch.ops.spgemm_sell, "
            "graphblas_tpu_torch.ops.spgemm_fast, "
            "graphblas_tpu_torch.ops.select, "
            "graphblas_tpu_torch.kernels.sortreduce, "
            "graphblas_tpu_torch.kernels.static_route, "
            "graphblas_tpu_torch.utils.native, "
            "graphblas_tpu_torch.utils.tensor_cache, "
            "graphblas_tpu_torch.testing, "
            "graphblas_tpu_torch.tools.probe_sortreduce, "
            "graphblas_tpu_torch.tools.probe_unsigned, "
            "graphblas_tpu_torch.core.names, "
            "graphblas_tpu_torch.core.context, "
            "graphblas_tpu_torch.core.iterator, "
            "graphblas_tpu_torch.ops.ewise, "
            "graphblas_tpu_torch.ops.element, "
            "graphblas_tpu_torch.ops.extract, "
            "graphblas_tpu_torch.ops.assign, "
            "graphblas_tpu_torch.ops.kron, "
            "graphblas_tpu_torch.ops.concat, "
            "graphblas_tpu_torch.ops.diag, "
            "graphblas_tpu_torch.ops.resize, "
            "graphblas_tpu_torch.ops.sort, "
            "graphblas_tpu_torch.ops.serialize, "
            "graphblas_tpu_torch.parallel, "
            "graphblas_tpu_torch.parallel.dist, "
            "graphblas_tpu_torch.parallel.launch; "
            "new = set(sys.modules) - before; "
            "bad = sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'graphblas_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_chip_smoke_import_brings_no_jax():
    """chip_smoke.py runs its phases under ``__main__`` only: importing it
    loads neither JAX, the JAX package nor bench_real.py (a JAX-era
    script); its graphs come from the port's own generator."""
    code = ("import sys; before = set(sys.modules); import chip_smoke; "
            "new = set(sys.modules) - before; "
            "bad = sorted(m for m in new if m.split('.')[0] in "
            "('jax', 'jaxlib', 'graphblas_tpu', 'bench_real')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert "bench_real" not in f.read().replace("bench_real.py", "")


@pytest.mark.parametrize("seed", [7, 1])
def test_rmat_edges_matches_bench_real(seed):
    """The port's copy of the RMAT generator draws the same graph as
    bench_real.py's (scale 10, edge factor 16)."""
    import bench_real
    from graphblas_tpu_torch.testing import rmat_edges
    want = bench_real.rmat_edges(10, 16, np.random.default_rng(seed))
    got = rmat_edges(10, 16, np.random.default_rng(seed))
    assert got[2] == want[2] == 1 << 10
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
