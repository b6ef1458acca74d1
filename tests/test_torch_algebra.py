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


@pytest.mark.parametrize("ty", [TT.UINT16, TT.UINT32, TT.UINT64])
def test_unsigned_arithmetic_not_implemented(ty):
    x = torch.tensor([1, 2], dtype=ty.torch_dtype)
    with pytest.raises(NotImplementedError):
        TO.PLUS(x, x)
    with pytest.raises(NotImplementedError):
        TK.segment_reduce(x, torch.tensor([0, 0]), 1, TM.MIN)


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
            "graphblas_tpu_torch.testing; "
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
