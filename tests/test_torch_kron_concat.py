"""Port parity: kronecker, concat / split, diag / vector_diag and resize
/ reshape (graphblas_tpu_torch.ops.{kron, concat, diag, resize}) against
graphblas_tpu on the same seeded operands, the JAX side on its XLA path.

kron applies one op per product; the others move values.  So every
result is held bitwise equal, on each storage format and orientation
and on UINT64 values on both sides of 2^63 (TIMES wraps there).
"""

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.ops import resize as JR
from graphblas_tpu_torch.ops import resize as TR
from torch_parity import (assert_dense, assert_same,  # noqa: F401
                          cpu_default, mask_pair, typed_pair, xla_path)

pytestmark = pytest.mark.usefixtures("xla_path")

FORMATS = ["sparse", "hyper", "bitmap", "full"]


def _ops(name):
    return getattr(gb.operators, name), getattr(gt.operators, name)


# ---- kron -------------------------------------------------------------------

@pytest.mark.parametrize("fmt,orient", [("sparse", "row"), ("sparse", "col"),
                                        ("hyper", "row"), ("bitmap", "row"),
                                        ("full", "col")])
def test_kron_formats(rng, fmt, orient):
    Aj, At = typed_pair(rng, (5, 6), 0.4, np.float64, fmt, orient, which=50)
    Bj, Bt = typed_pair(rng, (4, 7), 0.4, np.float64, which=51)
    jt, tt = _ops("TIMES")
    assert_same(gb.kronecker(Aj, Bj, jt), gt.kronecker(At, Bt, tt))
    assert_same(gb.kronecker(Bj, Aj, jt), gt.kronecker(Bt, At, tt))


@pytest.mark.parametrize("dt,op", [(np.uint64, "TIMES"), (np.int32, "PLUS"),
                                   (np.float32, "MINUS"), (np.bool_, "LXOR"),
                                   (np.complex128, "FIRST")])
def test_kron_types(rng, dt, op):
    Aj, At = typed_pair(rng, (5, 6), 0.4, dt, which=50)
    Bj, Bt = typed_pair(rng, (4, 7), 0.4, dt, which=51)
    jo, to = _ops(op)
    assert_same(gb.kronecker(Aj, Bj, jo), gt.kronecker(At, Bt, to))


def test_kron_mask_accum_transpose(rng):
    Aj, At = typed_pair(rng, (6, 5), 0.4, np.float64, which=52)
    Bj, Bt = typed_pair(rng, (4, 7), 0.4, np.float64, which=51)
    Cj, Ct = typed_pair(rng, (20, 42), 0.2, np.float64, which=53)
    Mj, Mt = mask_pair(rng, (20, 42), 54)
    jt, tt = _ops("TIMES")
    jp, tp = _ops("PLUS")
    want = gb.kronecker(Aj, Bj, jt, C=Cj.dup(), mask=Mj, accum=jp,
                        desc=gb.Descriptor(transpose0=True))
    got = gt.kronecker(At, Bt, tt, C=Ct.dup(), mask=Mt, accum=tp,
                       desc=gt.Descriptor(transpose0=True))
    assert_same(want, got)


def test_kron_empty_and_int64_columns(rng):
    """An empty operand; and n * q past 2^31 (the columns stay exact in
    int64 until the int32 index cast, as in the JAX package)."""
    Aj, At = typed_pair(rng, (5, 6), 0.4, np.float64, which=50)
    Ej = gb.Matrix.new(gb.types.FP64, 3, 2)
    jt, tt = _ops("TIMES")
    assert_same(gb.kronecker(Aj, Ej, jt),
                gt.kronecker(At, gt.Matrix.new(gt.types.FP64, 3, 2), tt))
    S = gt.Matrix.from_coo([0, 1], [1, 0], [2.0, 3.0], (2, 1 << 16))
    K = gt.kronecker(S, gt.Matrix.from_coo([0], [5], [4.0], (1, 1 << 15)),
                     tt)
    assert K.shape == (2, 1 << 31)
    r, c, v = (x.numpy() for x in K.coo())
    np.testing.assert_array_equal(r, [0, 1])
    np.testing.assert_array_equal(c.astype(np.int64),
                                  [(1 << 15) + 5, 5])
    np.testing.assert_array_equal(v, [8.0, 12.0])


# ---- concat / split ---------------------------------------------------------

@pytest.mark.parametrize("dt", [np.float64, np.uint64])
def test_concat_split(rng, dt):
    tiles = [[typed_pair(rng, (4, 6), 0.4, dt, "sparse", which=55),
              typed_pair(rng, (4, 3), 0.4, dt, "bitmap", which=56)],
             [typed_pair(rng, (5, 6), 0.4, dt, "hyper", which=57),
              typed_pair(rng, (5, 3), 0.4, dt, "sparse", "col", which=58)]]
    Cj = gb.concat([[t[0] for t in row] for row in tiles])
    Ct = gt.concat([[t[1] for t in row] for row in tiles])
    assert_same(Cj, Ct)
    for rs, cs in (([4, 5], [6, 3]), ([1, 3, 5], [2, 2, 5])):
        for tj, tt in zip(sum(gb.split(Cj, rs, cs), []),
                          sum(gt.split(Ct, rs, cs), [])):
            assert_same(tj, tt)
    back = gt.concat(gt.split(Ct, [1, 3, 5], [2, 2, 5]))
    for name in ("indptr", "indices", "values"):
        assert getattr(back, name).equal(getattr(Ct, name))


def test_concat_errors(rng):
    _, At = typed_pair(rng, (4, 6), 0.4, np.float64, which=55)
    _, Bt = typed_pair(rng, (5, 3), 0.4, np.float64, which=58)
    with pytest.raises(gt.errors.DimensionMismatch):
        gt.concat([[At, Bt]])
    with pytest.raises(gt.errors.DimensionMismatch):
        gt.split(At, [2, 3], [6])


# ---- diag -------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["sparse", "bitmap"])
@pytest.mark.parametrize("k", [0, 2, -1])
def test_diag(rng, k, fmt):
    vj, vt = typed_pair(rng, (7, 1), 0.6, np.int64, fmt, klass=gb.Vector,
                        which=59)
    assert_same(gb.diag(vj, k), gt.diag(vt, k))


@pytest.mark.parametrize("k", [1, 0, -2])
@pytest.mark.parametrize("fmt", ["sparse", "full"])
def test_vector_diag(rng, k, fmt):
    Aj, At = typed_pair(rng, (6, 8), 0.5, np.uint64, fmt, which=60)
    got = gt.vector_diag(At, k)
    assert isinstance(got, gt.Vector)
    assert_same(gb.vector_diag(Aj, k), got)


def test_vector_diag_outside(rng):
    _, At = typed_pair(rng, (6, 8), 0.5, np.float64, which=60)
    with pytest.raises(gt.errors.InvalidValue):
        gt.vector_diag(At, 8)


# ---- resize / reshape -------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("size", [(12, 7), (5, 14), (10, 10)])
def test_resize(rng, fmt, size):
    Aj, At = typed_pair(rng, (10, 10), 0.4, np.float64, fmt, "col",
                        which=61)
    assert_same(JR.resize(Aj, *size), TR.resize(At, *size))


@pytest.mark.parametrize("orient", ["row", "col"])
@pytest.mark.parametrize("by_col", [True, False])
def test_reshape(rng, by_col, orient):
    Aj, At = typed_pair(rng, (6, 10), 0.4, np.uint64, "sparse", orient,
                        which=62)
    assert_same(JR.reshape(Aj, 4, 15, by_col),
                TR.reshape(At, 4, 15, by_col))
    with pytest.raises(gt.errors.DimensionMismatch):
        TR.reshape(At, 4, 16)
