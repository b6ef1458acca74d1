"""Port parity: user-defined struct types (graphblas_tpu_torch.core.types.
struct_type) against graphblas_tpu's, as its tests/test_struct_types.py
drives them: gauss integers {real, imag} (Demo gauss_demo.c) built with a
user dup, eWise add, the gauss mxm semiring, reduce_scalar and apply,
and the 4x4 wildtype (wildtype_demo.c); then the same on sparse
operands, through extract, and through serialize.  The row-wise reduce
is held against numpy: the JAX package's fails on a struct.

Integer fields are held bitwise equal; the wildtype's float64 fields
take one add per entry, also bitwise.  The JAX package cannot read a
struct blob back (its deserialize looks the name up among the built-in
types), so a struct blob is held to the same bytes in both packages and
read by the port.
"""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.core import types as JT
from graphblas_tpu.ops import serialize as JS
from graphblas_tpu_torch.core import types as TT
from torch_parity import (assert_same, cpu_default, to_port,  # noqa: F401
                          xla_path)

pytestmark = pytest.mark.usefixtures("xla_path")

J_GAUSS = JT.struct_type("Gauss", np.int64, (2,))
T_GAUSS = TT.struct_type("Gauss", np.int64, (2,))


def _jmult(x, y):
    import jax.numpy as jnp
    xr, xi, yr, yi = x[..., 0], x[..., 1], y[..., 0], y[..., 1]
    return jnp.stack([xr * yr - xi * yi, xr * yi + xi * yr], axis=-1)


def _tmult(x, y):
    xr, xi, yr, yi = x[..., 0], x[..., 1], y[..., 0], y[..., 1]
    return torch.stack([xr * yr - xi * yi, xr * yi + xi * yr], dim=-1)


J_ADD = gb.binary_op(lambda x, y: x + y, "gauss_add", commutative=True)
T_ADD = gt.binary_op(lambda x, y: x + y, "gauss_add", commutative=True)
J_MULT = gb.binary_op(_jmult, "gauss_mult")
T_MULT = gt.binary_op(_tmult, "gauss_mult")
J_MON = gb.make_monoid(J_ADD, identity=np.array([0, 0]))
T_MON = gt.make_monoid(T_ADD, identity=np.array([0, 0]))
J_SR = gb.make_semiring(J_MON, J_MULT, "gauss_plus_times")
T_SR = gt.make_semiring(T_MON, T_MULT, "gauss_plus_times")


def _gauss(rng, m, n, density=None):
    """(JAX, port) gauss matrices and the complex mirror: FULL, or SPARSE
    with ``density``."""
    re = rng.integers(-3, 4, (m, n))
    im = rng.integers(-3, 4, (m, n))
    vals = np.stack([re, im], axis=-1).astype(np.int64)
    if density is None:
        import jax.numpy as jnp
        A = gb.Matrix((m, n), J_GAUSS, gb.FULL, values=jnp.asarray(vals))
        return A, to_port(A), re + 1j * im
    keep = np.random.default_rng(7 + m).random((m, n)) < density
    r, c = np.nonzero(keep)
    A = gb.Matrix.from_coo(r, c, vals[r, c], (m, n), dtype=J_GAUSS,
                           dup=J_ADD)
    return A, to_port(A), np.where(keep, re + 1j * im, 0)


def _complex(M):
    v, p = (x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)
            for x in M.to_dense_pair())
    return np.where(p, v[..., 0] + 1j * v[..., 1], 0), p


def test_struct_build_and_extract():
    rows = np.array([0, 1, 2, 1])
    cols = np.array([1, 0, 2, 0])
    vals = np.array([[1, 2], [3, 4], [5, 6], [10, 10]], np.int64)
    Aj = gb.Matrix.from_coo(rows, cols, vals, (3, 3), dtype=J_GAUSS,
                            dup=J_ADD)
    At = gt.Matrix.from_coo(rows, cols, vals, (3, 3), dtype=T_GAUSS,
                            dup=T_ADD)
    assert At.nvals == 3 and At.dtype.is_struct
    r, c, v = (x.numpy() for x in At.coo())
    got = dict(zip(zip(r.tolist(), c.tolist()), v.tolist()))
    assert got[(1, 0)] == [13, 14] and got[(0, 1)] == [1, 2]
    assert_same(Aj, At)
    assert_same(gb.extract(Aj, [1, 2], [0, 2]),
                gt.extract(At, [1, 2], [0, 2]))


@pytest.mark.parametrize("density", [None, 0.5])
def test_struct_ewise_add(rng, density):
    Aj, At, ca = _gauss(rng, 4, 5, density)
    Bj, Bt, cb = _gauss(rng, 4, 5, density)
    Ct = gt.ewise_add(At, Bt, T_ADD)
    assert_same(gb.ewise_add(Aj, Bj, J_ADD), Ct)
    np.testing.assert_array_equal(_complex(Ct)[0], ca + cb)


def test_struct_ewise_mult_sparse(rng):
    Aj, At, ca = _gauss(rng, 6, 5, 0.5)
    Bj, Bt, cb = _gauss(rng, 6, 5, 0.6)
    assert_same(gb.ewise_mult(Aj, Bj, J_MULT), gt.ewise_mult(At, Bt, T_MULT))


@pytest.mark.parametrize("density", [None, 0.6])
def test_struct_mxm_gauss_semiring(rng, density):
    """The classic path (SELL and the fast tier decline a struct)."""
    Aj, At, ca = _gauss(rng, 4, 3, density)
    Bj, Bt, cb = _gauss(rng, 3, 5, density)
    Ct = gt.mxm(At, Bt, T_SR)
    assert_same(gb.mxm(Aj, Bj, J_SR), Ct)
    cv, cp = _complex(Ct)
    np.testing.assert_array_equal(cv, np.where(cp, ca @ cb, 0))


@pytest.mark.parametrize("density", [None, 0.5])
def test_struct_reduce(rng, density):
    Aj, At, ca = _gauss(rng, 4, 5, density)
    s = gt.reduce_scalar(At, T_MON)
    assert s.tolist() == [int(ca.real.sum()), int(ca.imag.sum())]
    assert s.tolist() == gb.reduce_scalar(Aj, J_MON).tolist()
    # row-wise, against numpy: the JAX package's reduce to a vector
    # broadcasts its presence mask against the struct's field dims
    # without padding it (graphblas_tpu/ops/reduce.py:61, 72) and fails
    wv, wp = _complex(gt.reduce(At, T_MON))
    np.testing.assert_array_equal(
        wp[:, 0], np.asarray(Aj.to_dense_pair()[1]).any(axis=1))
    np.testing.assert_array_equal(wv[:, 0], ca.sum(axis=1))


@pytest.mark.parametrize("density", [None, 0.5])
def test_struct_apply(rng, density):
    Aj, At, ca = _gauss(rng, 3, 3, density)
    jconj = gb.unary_op(lambda x: x * np.array([1, -1]), "gauss_conj")
    tconj = gt.unary_op(lambda x: x * torch.tensor([1, -1]), "gauss_conj")
    Ct = gt.apply(At, tconj)
    assert_same(gb.apply(Aj, jconj), Ct)
    cv, _ = _complex(Ct)
    np.testing.assert_array_equal(cv, np.conj(ca))


def test_wildtype_4x4(rng):
    """wildtype_demo analog: double[4][4] entries, an eWise add."""
    import jax.numpy as jnp
    JW = JT.struct_type("wildtype", np.float64, (4, 4))
    TW = TT.struct_type("wildtype", np.float64, (4, 4))
    va = rng.standard_normal((2, 2, 4, 4))
    Aj = gb.Matrix((2, 2), JW, gb.FULL, values=jnp.asarray(va))
    Bj = gb.Matrix((2, 2), JW, gb.FULL, values=jnp.asarray(va * 2))
    At, Bt = to_port(Aj), to_port(Bj)
    assert At.dtype == TW
    Ct = gt.ewise_mult(At, Bt, gt.binary_op(lambda x, y: x + y, "wt_add"))
    Cj = gb.ewise_mult(Aj, Bj, gb.binary_op(lambda x, y: x + y, "wt_add"))
    assert_same(Cj, Ct)
    np.testing.assert_array_equal(Ct.to_dense_pair()[0].numpy(),
                                  va + va * 2)
    Ct.check()
    assert Ct.to_format(gt.SPARSE, gt.COL).isequal(Ct)


@pytest.mark.parametrize("density", [None, 0.5])
def test_struct_serialize(rng, density):
    Aj, At, _ = _gauss(rng, 5, 4, density)
    for codec in ("none", "zlib", "gbz"):
        blob = gt.serialize(At, codec)
        assert blob == JS.serialize(Aj, codec)
        back = gt.deserialize(blob, device="cpu")
        assert back.dtype == T_GAUSS and back.isequal(At)
    # a reader that never saw the type makes it from the values
    hdr = JS.serialized_get(blob)
    renamed = blob.replace(b'"dtype": "Gauss"', b'"dtype": "Gausz"', 1)
    assert hdr["dtype"] == "Gauss"
    other = gt.deserialize(renamed, device="cpu")
    assert other.dtype.shape == (2,) and other.dtype.name == "Gausz"


def test_struct_cast_refused():
    with pytest.raises(gt.errors.DomainMismatch):
        TT.cast(torch.zeros(3, dtype=torch.int64), T_GAUSS)
