"""GxB_BF16 in the port against the JAX package on the CPU.

The port finds the type by name, by ``torch.bfloat16`` and by a tensor of
that dtype (``ml_dtypes`` arrays, where the JAX package hands them out,
too), builds, casts, and runs ewise_add, apply, mxv, vxm, the row reduce
and the scalar reduce on it.  Two documented differences:

* host carrier: a BF16 array leaves the port as float32 (to_scipy,
  extract_element, reduce_scalar), which holds every bf16 value exactly;
  the JAX package hands out ``ml_dtypes.bfloat16``;
* accumulation: the port's PLUS reductions of BF16 add in float32 and
  round once to bf16; the JAX package adds in bf16.  The two are equal
  bitwise where every partial sum is exact in bf16; otherwise the port
  equals the float64 sum rounded once to bf16 (its float32 sums are
  exact here), and a row of 3000 ones shows the difference: the JAX sum
  stalls at 256, the port gives 3000 rounded to bf16, 3008.

Blobs are byte-equal with the JAX package's at every codec both have,
and the port reads the JAX package's BF16 blob.
"""

import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.core import types as JT
from graphblas_tpu.ops import serialize as JSER
from graphblas_tpu_torch.core import types as TT
from graphblas_tpu_torch.ops import serialize as TSER
from torch_parity import cpu_default, to_port, xla_path  # noqa: F401

pytestmark = pytest.mark.usefixtures("xla_path")

BF = ml_dtypes.bfloat16
SHAPE = (30, 40)


def _bf16_round(x):
    """float64 values rounded once to bf16, on the float32 carrier."""
    return np.asarray(x, np.float64).astype(BF).astype(np.float32)


def _coo(rng, exact, nnz=500, shape=SHAPE):
    """Random COO triples; ``exact``: small integers, so every partial
    sum is exact in bf16; else multiples of 1/64 up to 4 (bf16 values
    whose float32 sums are exact, and whose bf16 sums are not)."""
    r = rng.integers(0, shape[0], nnz)
    c = rng.integers(0, shape[1], nnz)
    key = np.unique(r * shape[1] + c)
    r, c = key // shape[1], key % shape[1]
    v = rng.integers(0, 4, key.size) if exact \
        else rng.integers(-256, 257, key.size) / 64
    return r, c, v.astype(np.float32)


def _both(rng, exact):
    r, c, v = _coo(rng, exact)
    Aj = gb.Matrix.from_coo(r, c, v.astype(BF), SHAPE)
    At = gt.Matrix.from_coo(r, c, v, SHAPE, dtype="GxB_BF16")
    return Aj, At, (r, c, v)


def _dense(M):
    v, p = M.to_dense_pair()
    if isinstance(v, torch.Tensor):
        return TT.host(v), TT.host(p)
    return np.asarray(v).astype(np.float32), np.asarray(p)


def _same(Mj, Mt):
    vj, pj = _dense(Mj)
    vt, pt = _dense(Mt)
    np.testing.assert_array_equal(pj, pt)
    assert vt.dtype == np.float32
    np.testing.assert_array_equal(vj[pj].view(np.int32),
                                  vt[pt].view(np.int32))


def test_lookup():
    assert TT.lookup("GxB_BF16") is TT.BF16
    assert TT.lookup(torch.bfloat16) is TT.BF16
    assert TT.lookup(torch.zeros(2, dtype=torch.bfloat16)) is TT.BF16
    assert TT.lookup(np.dtype(BF)) is TT.BF16
    assert TT.lookup(np.float32) is TT.FP32     # float32 stays FP32
    assert TT.BF16.name == JT.BF16.name and TT.BF16.is_float
    assert TT.BF16 not in TT.ALL_TYPES and JT.BF16 not in JT.ALL_TYPES
    assert TT.upcast_pair(TT.BF16, TT.INT8) is TT.BF16
    assert TT.upcast_pair(TT.BF16, TT.FP32) is TT.FP32
    assert TT.upcast_pair(TT.BF16, TT.FC64) is TT.FC64


def test_build_and_host_carrier():
    rng = np.random.default_rng(0)
    Aj, At, (r, c, v) = _both(rng, exact=False)
    assert At.dtype is TT.BF16 and At.values.dtype == torch.bfloat16
    _same(Aj, At)
    # the host carrier: float32 in the port, ml_dtypes.bfloat16 in JAX
    S = At.to_scipy()
    assert S.dtype == np.float32
    assert Aj.to_scipy().dtype == BF
    np.testing.assert_array_equal(S.toarray(), _dense(Aj)[0])
    x = At.extract_element(int(r[0]), int(c[0]))
    assert x.dtype == np.float32 and x == v[0]
    # numpy float64 values round once, as JAX's bf16 build rounds them
    w = rng.standard_normal(r.size)
    Bt = gt.Matrix.from_coo(r, c, w, SHAPE, dtype=TT.BF16)
    Bj = gb.Matrix.from_coo(r, c, w.astype(BF), SHAPE)
    _same(Bj, Bt)
    # the JAX package's ml_dtypes array names the type
    Ct = gt.Matrix.from_coo(r, c, w.astype(BF), SHAPE)
    assert Ct.dtype is TT.BF16
    _same(Bj, Ct)


@pytest.mark.parametrize("to", ["GrB_INT32", "GrB_UINT8", "GrB_INT16",
                                "GrB_BOOL", "GrB_FP64", "GxB_FC64"])
def test_cast_from_bf16(to):
    """bf16 -> integers round to nearest and saturate (NaN -> 0), as for
    FP32 (the reference's nearbyint), held against numpy: the JAX
    package's cast truncates bf16 (1.5 and 1.75 -> 1) where its float32
    cast rounds.  bool is x != 0 and floats and complex widen exactly,
    as in the JAX package."""
    x = np.array([1.5, 2.5, -2.5, 1.75, 300.0, -3e9, 3e9, 0.0, np.nan,
                  0.0078125], np.float32)
    ty = TT.lookup(to)
    got = TT.host(TT.cast(torch.from_numpy(x).to(torch.bfloat16), ty))
    if ty.is_integer:
        info = np.iinfo(ty.np_dtype)
        want = np.clip(np.nan_to_num(np.rint(x.astype(np.float64))),
                       info.min, info.max).astype(ty.np_dtype)
        jax = np.asarray(JT.cast(x.astype(BF), JT.lookup(to)))
        assert jax[0] == 1 and want[0] == 2 == got[0]
    else:
        want = np.asarray(JT.cast(x.astype(BF), JT.lookup(to)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("src", [np.float64, np.int32, np.uint16, np.bool_])
def test_cast_to_bf16(src):
    x = np.array([0.1, 1.0, 257.0, 1e5, 3.14159, -7.0, 0.0])
    x = x.astype(src) if src != np.uint16 else np.abs(x).astype(src)
    got = TT.host(TT.cast(torch.from_numpy(x), TT.BF16))
    want = np.asarray(JT.cast(x, JT.BF16)).astype(np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("exact", [True, False])
def test_ewise_add_and_apply(exact):
    rng = np.random.default_rng(1)
    Aj, At, _ = _both(rng, exact)
    Bj, Bt, _ = _both(rng, exact)
    _same(gb.ewise_add(Aj, Bj, gb.operators.PLUS),
          gt.ewise_add(At, Bt, gt.operators.PLUS))
    _same(gb.ewise_mult(Aj, Bj, gb.operators.TIMES),
          gt.ewise_mult(At, Bt, gt.operators.TIMES))
    _same(gb.apply(Aj, gb.operators.AINV), gt.apply(At, gt.operators.AINV))
    _same(gb.ewise_add(Aj, gb.transpose(gb.transpose(Bj)),
                       gb.operators.MAX),
          gt.ewise_add(At, gt.transpose(gt.transpose(Bt)),
                       gt.operators.MAX))


def _rowsums(r, v, m):
    out = np.zeros(m)
    np.add.at(out, r, v.astype(np.float64))
    return out


@pytest.mark.parametrize("exact", [True, False])
def test_mxv_reduce(exact):
    """Bitwise equal to the JAX package where every partial sum is exact
    in bf16; else the float64 sum rounded once to bf16."""
    rng = np.random.default_rng(2)
    Aj, At, (r, c, v) = _both(rng, exact)
    xj = gb.Vector.from_dense(np.ones(SHAPE[1], BF))
    xt = gt.Vector.from_dense(torch.ones(SHAPE[1], dtype=torch.bfloat16))
    yt = gt.mxv(At, xt, gt.semiring.PLUS_TIMES)
    rt = gt.reduce(At, gt.monoid.PLUS)
    st = gt.reduce_scalar(At, gt.monoid.PLUS)
    assert yt.dtype is TT.BF16 and rt.dtype is TT.BF16
    assert st.dtype == np.float32
    if exact:
        _same(gb.mxv(Aj, xj, gb.semiring.PLUS_TIMES), yt)
        _same(gb.reduce(Aj, gb.monoid.PLUS), rt)
        assert st == np.float32(gb.reduce_scalar(Aj, gb.monoid.PLUS))
        ut = gt.vxm(gt.Vector.from_dense(torch.ones(SHAPE[0],
                                                    dtype=torch.bfloat16)),
                    At, gt.semiring.PLUS_TIMES)
        uj = gb.vxm(gb.Vector.from_dense(np.ones(SHAPE[0], BF)), Aj,
                    gb.semiring.PLUS_TIMES)
        _same(uj, ut)
    want = _bf16_round(_rowsums(r, v, SHAPE[0]))
    for y in (yt, rt):
        yv, yp = (a.reshape(-1) for a in _dense(y))
        np.testing.assert_array_equal(yv[yp], want[yp])
    assert st == _bf16_round(v.astype(np.float64).sum())


def test_sparse_vxm_and_min_plus():
    """vxm with a sparse u (the scatter path, float32 sums) against the
    JAX package on exact values; MIN_PLUS mxm against numpy, since the
    JAX package's MIN identity for bf16 raises (``np.iinfo`` of an
    ``ml_dtypes`` type, graphblas_tpu/core/monoid.py:34)."""
    rng = np.random.default_rng(5)
    Aj, At, (r, c, v) = _both(rng, exact=True)
    idx = np.array([1, 4, 9, 17, 28])
    val = np.array([1, 2, 3, 1, 2], np.float32)
    uj = gb.Vector.from_coo(idx, val.astype(BF), SHAPE[0])
    ut = gt.Vector.from_coo(idx, val, SHAPE[0], dtype=TT.BF16)
    _same(gb.vxm(uj, Aj, gb.semiring.PLUS_TIMES),
          gt.vxm(ut, At, gt.semiring.PLUS_TIMES))
    with pytest.raises(ValueError):
        gb.mxm(Aj, gb.transpose(Aj), gb.semiring.MIN_PLUS)
    got = gt.mxm(At, gt.transpose(At), gt.semiring.MIN_PLUS)
    d = np.full(SHAPE, np.inf)
    d[r, c] = v
    want = (d[:, None, :] + d[None, :, :]).min(axis=2)     # A (min.+) A'
    gv, gp = _dense(got)
    np.testing.assert_array_equal(gp, np.isfinite(want))
    np.testing.assert_array_equal(gv[gp], want[gp])


def test_3000_ones_row():
    """The row of 3000 ones: the JAX package's bf16 sum stalls at 256
    (256 + 1 rounds back to 256); the port's float32 sum rounds once to
    bf16(3000) = 3008.  Both scalar reduces give 3008."""
    n = 3000
    r, c = np.zeros(n, np.int64), np.arange(n)
    Aj = gb.Matrix.from_coo(r, c, np.ones(n, BF), (2, n))
    At = gt.Matrix.from_coo(r, c, np.ones(n, np.float32), (2, n),
                            dtype="GxB_BF16")
    xj = gb.Vector.from_dense(np.ones(n, BF))
    xt = gt.Vector.from_dense(torch.ones(n, dtype=torch.bfloat16))
    jax_mxv = _dense(gb.mxv(Aj, xj, gb.semiring.PLUS_TIMES))[0][0, 0]
    jax_row = _dense(gb.reduce(Aj, gb.monoid.PLUS))[0][0, 0]
    assert (jax_mxv, jax_row) == (256.0, 256.0)
    port_mxv = _dense(gt.mxv(At, xt, gt.semiring.PLUS_TIMES))[0][0, 0]
    port_row = _dense(gt.reduce(At, gt.monoid.PLUS))[0][0, 0]
    assert port_mxv == port_row == _bf16_round(3000.0) == 3008.0
    assert gt.reduce_scalar(At, gt.monoid.PLUS) == 3008.0
    assert float(gb.reduce_scalar(Aj, gb.monoid.PLUS)) == 3008.0


CODECS = ["none", "zlib", "gbz"] + (
    ["zstd"] if "zstd" in TSER._CODECS and "zstd" in JSER._CODECS else [])


@pytest.mark.parametrize("fmt", ["sparse", "bitmap", "full"])
@pytest.mark.parametrize("codec", CODECS)
def test_blob_bytes_equal(codec, fmt):
    rng = np.random.default_rng(3)
    Aj, At, _ = _both(rng, exact=False)
    if fmt == "full":
        d = rng.standard_normal(SHAPE)
        Aj = gb.Matrix.from_dense(d.astype(BF))
        At = gt.Matrix.from_dense(torch.from_numpy(d).to(torch.bfloat16))
    else:
        Aj, At = Aj.to_format(fmt), At.to_format(fmt)
    bj = JSER.serialize(Aj, compression=codec)
    bt = TSER.serialize(At, compression=codec)
    assert bt == bj
    assert TSER.serialized_get(bt)["arrays"]["values"]["dtype"] == \
        "bfloat16"
    Bt = TSER.deserialize(bj, device="cpu")
    assert Bt.dtype is TT.BF16 and Bt.values.dtype == torch.bfloat16
    _same(Aj, Bt)
    assert torch.equal(TSER.deserialize(bt, device="cpu").values.view(
        torch.int16), At.values.view(torch.int16))


def test_interop_carries_bf16():
    rng = np.random.default_rng(4)
    Aj, _, _ = _both(rng, exact=False)
    At = to_port(Aj)
    assert At.dtype is TT.BF16
    _same(Aj, At)
    S = sps.csr_matrix(At.to_scipy())
    assert S.dtype == np.float32
