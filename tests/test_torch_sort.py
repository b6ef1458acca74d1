"""Port parity: GxB_Matrix_sort (graphblas_tpu_torch.ops.sort) against
graphblas_tpu, the JAX side on its XLA path.

C (the sorted values) is held bitwise equal to the JAX package's
everywhere; P (their original columns) on the rows whose values are
distinct, since the JAX sort leaves the order of ties unspecified.  The
port breaks ties by column ascending, held against numpy's stable sort
everywhere.  Descending sorts of INT8 values holding -128 and of UINT64
values above 2^53 are held against numpy only: the JAX package negates
the values (-(-128) wraps to -128) and orders unsigned values through
float64 (distinct values above 2^53 tie).
"""

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from torch_parity import (assert_same, cpu_default, to_port,  # noqa: F401
                          typed_pair, xla_path)

pytestmark = pytest.mark.usefixtures("xla_path")

SHAPE = (12, 16)


def _numpy_sort(Aj, descending):
    """(C values, P columns) per row by numpy's stable sort: ties keep
    column order."""
    v, p = (np.asarray(x) for x in Aj.to_dense_pair())
    out = []
    for i in range(v.shape[0]):
        cols = np.flatnonzero(p[i])
        vals = v[i, cols]
        order = np.argsort(_desc_key(vals) if descending else vals,
                           kind="stable")
        out.append((vals[order], cols[order]))
    return out


def _desc_key(vals):
    """A key whose ascending order is ``vals`` descending, exact for every
    type (ranks of the distinct values)."""
    uniq = np.unique(vals)
    return len(uniq) - np.searchsorted(uniq, vals)


def _rows(M):
    """Each row's stored values, in column order (either package)."""
    v, p = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
            for x in M.to_dense_pair())
    return [v[i][p[i]] for i in range(v.shape[0])]


def _assert_against_numpy(At, Aj, op, descending):
    C, P = gt.sort(At, op)
    assert P.dtype == gt.types.INT64
    for (wv, wc), cv, pc in zip(_numpy_sort(Aj, descending), _rows(C),
                                _rows(P)):
        np.testing.assert_array_equal(cv, wv)
        np.testing.assert_array_equal(pc, wc)


@pytest.mark.parametrize("orient", ["row", "col"])
@pytest.mark.parametrize("fmt", ["sparse", "hyper", "bitmap", "full"])
@pytest.mark.parametrize("direction", ["LT", "GT"])
def test_sort_formats(rng, fmt, orient, direction):
    Aj, At = typed_pair(rng, SHAPE, 0.5, np.float64, fmt, orient, which=70)
    jop, top = getattr(gb.operators, direction), \
        getattr(gt.operators, direction)
    Cj, Pj = gb.sort(Aj, jop)
    Ct, Pt = gt.sort(At, top)
    assert_same(Cj, Ct)
    assert_same(Pj, Pt)      # normal values: every row distinct
    _assert_against_numpy(At, Aj, top, direction == "GT")


@pytest.mark.parametrize("dt", [np.int16, np.uint8, np.uint32, np.bool_,
                                np.float32, np.complex64])
@pytest.mark.parametrize("direction", ["LT", "GT"])
def test_sort_types_with_ties(rng, dt, direction):
    """Few distinct values, so most rows hold ties: C against JAX, P
    against JAX on the rows without ties and against the tie rule
    everywhere."""
    Aj, _ = typed_pair(rng, SHAPE, 0.6, np.int8, which=71)
    Aj = gb.apply(Aj, gb.operators.BAND, bind=("second", np.int8(3)))
    Aj = gb.apply(Aj, gb.operators.IDENTITY, out_dtype=gb.types.lookup(dt))
    At = to_port(Aj)
    jop, top = getattr(gb.operators, direction), \
        getattr(gt.operators, direction)
    Cj, Pj = gb.sort(Aj, jop)
    Ct, Pt = gt.sort(At, top)
    assert_same(Cj, Ct)
    distinct = [len(np.unique(r)) == len(r) for r in _rows(Ct)]
    assert not all(distinct)
    for ok, pj, pt in zip(distinct, _rows(Pj), _rows(Pt)):
        if ok:
            np.testing.assert_array_equal(pj, pt)
    _assert_against_numpy(At, Aj, top, direction == "GT")


@pytest.mark.parametrize("dt", [np.int8, np.int64, np.uint64])
def test_sort_descending_extremes(rng, dt):
    """INT*_MIN and UINT64 values above 2^53 (and across 2^63) in a
    descending sort, against numpy."""
    m, n = SHAPE
    info = np.iinfo(dt)
    r = np.repeat(np.arange(m), 6)
    c = np.tile(np.arange(0, 12, 2), m)
    if dt == np.uint64:
        base = np.uint64(1 << 60)
        v = base + rng.integers(0, 4, r.size).astype(np.uint64)
        v[::3] = np.uint64(info.max) - rng.integers(0, 3, v[::3].size
                                                    ).astype(np.uint64)
    else:
        v = rng.integers(info.min, info.min + 3, r.size, dtype=dt)
        v[::4] = info.max
    Aj = gb.Matrix.from_coo(r, c, v, SHAPE, dtype=dt)
    At = to_port(Aj)
    _assert_against_numpy(At, Aj, gt.operators.GT, True)
    _assert_against_numpy(At, Aj, gt.operators.LT, False)


def test_sort_transpose_and_empty(rng):
    Aj, At = typed_pair(rng, SHAPE, 0.5, np.float64, which=70)
    d_j, d_t = (gb.Descriptor(transpose0=True),
                gt.Descriptor(transpose0=True))
    Cj, Pj = gb.sort(Aj, desc=d_j)
    Ct, Pt = gt.sort(At, desc=d_t)
    assert Ct.shape == (16, 12)
    assert_same(Cj, Ct)
    assert_same(Pj, Pt)
    C, P = gt.sort(gt.Matrix.new(gt.types.FP32, 3, 4))
    assert C.nvals == 0 and P.nvals == 0 and P.dtype == gt.types.INT64


def test_sort_user_comparator(rng):
    """Another comparator runs the host tier: |x| descending here."""
    Aj, At = typed_pair(rng, SHAPE, 0.5, np.float64, which=70)
    jop = gb.binary_op(lambda x, y: abs(x) > abs(y), "abs_gt")
    top = gt.binary_op(lambda x, y: abs(x) > abs(y), "abs_gt")
    Cj, Pj = gb.sort(Aj, jop)
    Ct, Pt = gt.sort(At, top)
    assert_same(Cj, Ct)
    assert_same(Pj, Pt)


def test_sort_user_comparator_guard(monkeypatch):
    """Above USER_CMP_MAX_NNZ entries the host tier refuses."""
    from graphblas_tpu_torch.ops import sort as TS
    monkeypatch.setattr(TS, "USER_CMP_MAX_NNZ", 10)
    A = gt.Matrix.from_coo(np.arange(11), np.zeros(11, np.int64),
                           np.arange(11.0), (11, 1))
    op = gt.binary_op(lambda x, y: x < y, "my_lt")
    with pytest.raises(gt.errors.InvalidValue, match="user comparator"):
        gt.sort(A, op)
    C, _ = gt.sort(A, gt.operators.LT)
    assert C.nvals == 11
