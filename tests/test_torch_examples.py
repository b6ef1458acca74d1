"""The port's demos (graphblas_tpu_torch/examples/) on the CPU against the
same calls made on the JAX package (the JAX demos are scripts, so their
calls are repeated here at the demos' sizes)."""

import numpy as np
import pytest
import scipy.sparse as sps

import graphblas_tpu as gb
from graphblas_tpu import algorithms as jalg
from graphblas_tpu.ops import serialize as JSER
from graphblas_tpu_torch.examples import (bfs_demo, context_demo, gauss_demo,
                                          kron_demo, semiring_demo,
                                          serialize_demo)
from torch_parity import cpu_default, xla_path  # noqa: F401

pytestmark = pytest.mark.usefixtures("xla_path")


def test_bfs_demo():
    got = bfs_demo.main(device="cpu")
    A = gb.Matrix.from_scipy(bfs_demo.graph())
    lv, lp = (np.asarray(a) for a in jalg.bfs_levels(A, 0).to_dense_1d())
    pv, pp = (np.asarray(a) for a in jalg.bfs_parents(A, 0).to_dense_1d())
    fused = np.asarray(jalg.bfs_levels_fused(A, 0))
    assert got["nvals"] == A.nvals
    assert got["reached"] == int(lp.sum())
    assert got["max_level"] == int(lv[lp].max())
    np.testing.assert_array_equal(got["levels"], np.where(lp, lv, -1))
    np.testing.assert_array_equal(got["fused_levels"], fused)
    assert got["fused_agrees"]
    assert got["parent_entries"] == int(pp.sum())
    np.testing.assert_array_equal(got["parents"], np.where(pp, pv, -1))


def test_context_demo():
    got = context_demo.main(device="cpu")
    S = sps.random(500, 500, 0.01, format="csr", random_state=0)
    A = gb.Matrix.from_scipy(S)
    y = gb.mxv(A, gb.Vector.from_dense(np.ones(500)),
               gb.semiring.PLUS_TIMES)
    want = float(np.asarray(gb.reduce_scalar(y, gb.monoid.PLUS)))
    assert len(got["results"]) == 4
    assert len(set(got["results"].values())) == 1
    assert abs(got["results"][0] - want) <= 1e-12 * abs(want)
    np.testing.assert_allclose(got["y"], np.asarray(y.to_dense_1d()[0]),
                               rtol=1e-12, atol=0)


def test_gauss_demo():
    import jax.numpy as jnp
    from graphblas_tpu.core import types as JT
    got = gauss_demo.main(device="cpu")
    Gauss = JT.struct_type("Gauss", np.int64, (2,))

    def gauss_mult(x, y):
        xr, xi = x[..., 0], x[..., 1]
        yr, yi = y[..., 0], y[..., 1]
        return jnp.stack([xr * yr - xi * yi, xr * yi + xi * yr], axis=-1)

    add = gb.binary_op(lambda x, y: x + y, "gauss_add", commutative=True)
    mon = gb.make_monoid(add, identity=np.array([0, 0]))
    sr = gb.make_semiring(mon, gb.binary_op(gauss_mult, "gauss_mult"),
                          "gauss_plus_times")
    rng = np.random.default_rng(0)
    va = np.stack([rng.integers(-3, 4, (4, 4)),
                   rng.integers(-3, 4, (4, 4))], axis=-1)
    C = gb.mxm(gb.Matrix((4, 4), Gauss, gb.FULL, values=jnp.asarray(va)),
               gb.Matrix((4, 4), Gauss, gb.FULL, values=jnp.asarray(va)), sr)
    np.testing.assert_array_equal(got["C"], np.asarray(C.to_dense_pair()[0]))
    np.testing.assert_array_equal(got["sum"],
                                  np.asarray(gb.reduce_scalar(C, mon)))
    assert got["matches"]


def test_kron_demo():
    got = kron_demo.main(device="cpu")
    seed = gb.Matrix.from_coo(*kron_demo.SEED, [1.0] * 5, (3, 3))
    G = seed
    for _ in range(3):
        G = gb.kronecker(G, seed, gb.operators.TIMES)
    r = np.asarray(G.coo()[0])
    deg = np.bincount(r, minlength=G.nrows)
    assert (got["nrows"], got["nvals"]) == (G.nrows, G.nvals) == (81, 625)
    assert got["max_out_degree"] == int(deg.max())
    assert got["empty_rows"] == int((deg == 0).sum())
    assert (got["graph"].to_scipy() != G.to_scipy()).nnz == 0


def test_semiring_demo():
    import jax.numpy as jnp
    got = semiring_demo.main(device="cpu")
    A = gb.Matrix.from_coo([0, 0, 1, 2], [1, 2, 2, 3],
                           [1.0, 4.0, 1.0, 1.0], (4, 4))
    d = gb.Vector.from_dense(np.array([0.0, np.inf, np.inf, np.inf]))
    for _ in range(3):
        d = gb.ewise_add(d, gb.vxm(d, A, gb.semiring.MIN_PLUS),
                         gb.operators.MIN)
    np.testing.assert_array_equal(got["distances"],
                                  np.asarray(d.to_dense_1d()[0]))
    np.testing.assert_array_equal(got["distances"], [0, 1, 2, 3])
    lse = gb.make_monoid(gb.binary_op(lambda x, y: jnp.logaddexp(x, y),
                                      "logaddexp"), identity=-np.inf)
    sr = gb.make_semiring(lse, gb.operators.PLUS, "LSE_PLUS")
    w = gb.mxv(gb.Matrix.from_dense(np.log(np.ones((3, 3)) / 3)),
               gb.Vector.from_dense(np.log(np.ones(3) / 3)), sr)
    np.testing.assert_allclose(got["lse"], np.asarray(w.to_dense_1d()[0]),
                               rtol=1e-12)
    clip01 = gb.unary_op(lambda x: jnp.clip(x, 0.0, 1.0), "clip01")
    C = gb.apply(gb.Matrix.from_dense(np.array([[-1.0, 0.5], [2.0, 0.1]])),
                 clip01)
    np.testing.assert_array_equal(got["clipped"], C.to_scipy().toarray())


def test_serialize_demo():
    got = serialize_demo.main(device="cpu")
    S = sps.random(2000, 2000, 0.005, format="csr", random_state=1)
    A = gb.Matrix.from_scipy(S)
    for codec in serialize_demo.CODECS:
        blob = JSER.serialize(A, compression=codec)
        meta = JSER.serialized_get(blob)
        assert got["blobs"][codec] == (len(blob), meta["nvals"],
                                       meta["format"])
    assert got["blob"] == JSER.serialize(A, compression="gbz")
    assert got["roundtrip"] and got["pack"]
