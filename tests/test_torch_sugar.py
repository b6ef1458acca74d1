"""Port parity: the Matrix / Vector operator sugar (``A[I, J]``,
``A[M]``, ``A[M] = x``, ``A + B``, ``2 * A``, ``A @ v``, ``A.T``,
``resize``/``reshape``, ...) against the same expressions on
graphblas_tpu, the JAX side on its XLA path.

Each expression runs one op per entry (or, for ``@``, integer-valued
sums), so the results are held bitwise equal.  ``A[M]`` and ``A[M] = x``
read the mask by its values in the port (an entry of M holding false
selects nothing, as @GrB logical indexing does); the JAX package reads
its structure (``graphblas_tpu/core/matrix.py:396-399``, a reference
fault), so with explicit false values they are held against numpy, and
against the JAX package only on masks that hold none.
"""

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from torch_parity import (assert_dense, assert_same,  # noqa: F401
                          cpu_default, dense_port, mask_pair, to_port,
                          typed_pair, xla_path)

pytestmark = pytest.mark.usefixtures("xla_path")

SHAPE = (16, 16)


def _int_valued(rng, which, fmt="sparse"):
    """An FP64 pair with small integer values (exact sums)."""
    Aj, _ = typed_pair(rng, SHAPE, 0.3, np.int8, fmt, which=which)
    Aj = gb.apply(Aj, gb.operators.IDENTITY, out_dtype=gb.types.FP64)
    return Aj, to_port(Aj)


def _np(M):
    return tuple(np.asarray(x) for x in M.to_dense_pair())


@pytest.mark.parametrize("key", ["lists", "slices", "row", "col"])
def test_getitem_extract(rng, key):
    Aj, At = typed_pair(rng, SHAPE, 0.3, np.float64, which=30)
    ij = {"lists": ([1, 4, 9], [0, 2, 15]),
          "slices": (slice(2, 12), slice(None, None, 3)),
          "row": (3, slice(None)), "col": ([0, 5, 6], 7)}[key]
    assert_same(Aj[ij], At[ij])


def test_getitem_element(rng):
    Aj, At = typed_pair(rng, SHAPE, 0.3, np.float64, which=30)
    v, p = _np(Aj)
    i, j = map(int, np.argwhere(p)[0])
    assert At[i, j] == v[i, j] == Aj[i, j]
    i, j = map(int, np.argwhere(~p)[0])
    with pytest.raises(gt.errors.NoValue):
        At[i, j]


@pytest.mark.parametrize("fmt", ["sparse", "bitmap"])
def test_getitem_mask(rng, fmt):
    """A[M] = C<M> = A with M read by its values."""
    Aj, At = typed_pair(rng, SHAPE, 0.4, np.float64, which=31)
    Mj, Mt = mask_pair(rng, SHAPE, 32)
    Mt = Mt.to_format(fmt)
    v, p = _np(Aj)
    mv, mp = _np(Mj)
    sel = p & mp & mv
    assert (mp & ~mv).any()
    assert_dense(At[Mt], np.where(sel, v, 0), sel)
    Mj1, Mt1 = mask_pair(rng, SHAPE, 32, explicit_false=False)
    assert_same(Aj[Mj1], At[Mt1])


@pytest.mark.parametrize("value", ["scalar", "matrix"])
def test_setitem_mask(rng, value):
    """A[M] = x: C<M> = x over all of A, M read by its values."""
    Aj, At = typed_pair(rng, SHAPE, 0.3, np.float64, which=33)
    Mj, Mt = mask_pair(rng, SHAPE, 34)
    v, p = _np(Aj)
    mv, mp = _np(Mj)
    sel = mp & mv
    if value == "scalar":
        x_j = x_t = 0.0
        xv, xp = np.zeros(SHAPE), np.ones(SHAPE, bool)
    else:
        x_j, x_t = typed_pair(rng, SHAPE, 0.5, np.float64, which=35)
        xv, xp = _np(x_j)
    B = At.dup()
    B[Mt] = x_t
    assert_dense(B, np.where(sel, xv, v), np.where(sel, xp, p))
    Mj1, Mt1 = mask_pair(rng, SHAPE, 34, explicit_false=False)
    Bj, Bt = Aj.dup(), At.dup()
    Bj[Mj1] = x_j
    Bt[Mt1] = x_t
    assert_same(Bj, Bt)


@pytest.mark.parametrize("key", ["region", "scalar", "element", "row"])
def test_setitem_region(rng, key):
    Aj, At = typed_pair(rng, SHAPE, 0.3, np.float64, which=36)
    Xj, Xt = typed_pair(rng, (3, 4), 0.6, np.float64, which=37)
    ij, xj, xt = {"region": (([1, 5, 9], [0, 3, 4, 8]), Xj, Xt),
                  "scalar": (([2, 3], slice(4, 9)), 7.5, 7.5),
                  "element": ((4, 6), -2.25, -2.25),
                  "row": ((3, [0, 3, 4, 8]), 1.5, 1.5)}[key]
    Aj[ij] = xj
    At[ij] = xt
    assert_same(Aj, At)


EXPRS = {
    "A+B": lambda A, B: A + B, "A+2": lambda A, B: A + 2,
    "2+A": lambda A, B: 2 + A, "A-B": lambda A, B: A - B,
    "A-2": lambda A, B: A - 2, "3-A": lambda A, B: 3 - A,
    "A*B": lambda A, B: A * B, "2*A": lambda A, B: 2 * A,
    "A*2": lambda A, B: A * 2, "A/B": lambda A, B: A / B,
    "A/4": lambda A, B: A / 4, "-A": lambda A, B: -A,
    "abs": lambda A, B: abs(A), "A**2": lambda A, B: A ** 2,
    "A+A.T": lambda A, B: A + A.T, "A@B": lambda A, B: A @ B,
}


@pytest.mark.parametrize("expr", list(EXPRS))
def test_arithmetic(rng, expr):
    Aj, At = _int_valued(rng, 38)
    Bj, Bt = _int_valued(rng, 39)
    f = EXPRS[expr]
    assert_same(f(Aj, Bj), f(At, Bt))


@pytest.mark.parametrize("fmt", ["sparse", "full"])
def test_matmul_vector(rng, fmt):
    """A @ v -> mxv over PLUS_TIMES (on the card: K2)."""
    Aj, At = _int_valued(rng, 38)
    x = rng.integers(-4, 5, SHAPE[1]).astype(np.float64)
    uj = gb.Vector.from_dense(x).to_format(fmt)
    ut = to_port(uj)
    got = At @ ut
    assert isinstance(got, gt.Vector)
    assert_same(Aj @ uj, got)


def test_methods(rng):
    """T, astype, isequal, reduce, reduce_scalar, dup, clear."""
    Aj, At = _int_valued(rng, 38)
    assert_same(Aj.T, At.T)
    assert_same(Aj.astype(gb.types.INT16), At.astype(gt.types.INT16))
    assert At.isequal(to_port(Aj)) and not At.isequal(At * 2)
    assert_same(Aj.reduce(gb.monoid.PLUS), At.reduce(gt.monoid.PLUS))
    assert float(Aj.reduce_scalar(gb.monoid.MAX)) == \
        float(At.reduce_scalar(gt.monoid.MAX))
    C = At.dup()
    C.clear()
    assert C.nvals == 0 and C.shape == At.shape and C.dtype == At.dtype


@pytest.mark.parametrize("fmt", ["sparse", "bitmap"])
def test_resize_reshape(rng, fmt):
    Aj, At = typed_pair(rng, SHAPE, 0.3, np.float64, fmt, which=40)
    Bj, Bt = Aj.dup(), At.dup()
    Bj.resize(20, 11)
    Bt.resize(20, 11)
    assert Bt.shape == (20, 11)
    assert_same(Bj, Bt)
    for by_col in (True, False):
        assert_same(Aj.reshape(8, 32, by_col), At.reshape(8, 32, by_col))
    v, p = _np(Aj)
    assert_dense(At.reshape(32, 8), v.reshape(32, 8, order="F"),
                 p.reshape(32, 8, order="F"))


def test_vector_items(rng):
    uj, ut = typed_pair(rng, (20, 1), 0.5, np.float64, klass=gb.Vector,
                        which=41)
    v, p = _np(uj)
    i = int(np.flatnonzero(p[:, 0])[0])
    assert ut[i] == uj[i] == v[i, 0]
    uj[3] = 9.5
    ut[3] = 9.5
    uj[(5, 0)] = -1.0
    ut[(5, 0)] = -1.0
    assert_same(uj, ut)
    assert ut[3] == 9.5 and ut[(5, 0)] == -1.0
