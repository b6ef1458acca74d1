"""Port vs the TPU kernels themselves, run in Pallas interpret mode on the
CPU: spmv_route, spmv_route_monoid and spmv_route_ds (graphblas_tpu) vs
the port's planned SpMV at n ~ 300.  Interpret mode is slow, so the file
is marked ``slow`` like tests/test_spmv_route.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from graphblas_tpu.kernels import spmv_route as JSPR
from graphblas_tpu_torch.kernels import spmv_route as SPR
from torch_parity import cpu_default  # noqa: F401

pytestmark = pytest.mark.slow

M, N = 300, 280


def _csr(dtype, seed):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 7, M)
    deg[9] = 900                               # a heavy row: JAX splits it
    rows = np.repeat(np.arange(M), deg)
    S = sps.csr_matrix((rng.standard_normal(rows.size).astype(dtype),
                        (rows, rng.integers(0, N, rows.size))),
                       shape=(M, N))
    S.sum_duplicates()
    x = rng.standard_normal(N).astype(dtype)
    return S, x


def _port(S, x):
    ip = torch.from_numpy(S.indptr.astype(np.int32))
    ix = torch.from_numpy(S.indices.astype(np.int32))
    p = SPR.build_plan(ip, ix, torch.from_numpy(S.data.copy()), S.shape)
    return p, torch.from_numpy(x)


def test_route_plus_times_vs_tpu_kernel():
    """fp32: the TPU kernel is exact-reduce fp32; 1e-5*max|y|."""
    S, x = _csr(np.float32, 0)
    jp = JSPR.build_plan(S.indptr, S.indices, S.data, S.shape)
    want = np.asarray(JSPR.spmv_route(jnp.asarray(x), jp, interpret=True))
    p, xt = _port(S, x)
    got = SPR.spmv_route(xt, p).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("add,mul", [("min", "plus"), ("max", "times"),
                                     ("min", "first"), ("max", "pair"),
                                     ("plus", "second")])
def test_route_monoid_vs_tpu_kernel(add, mul):
    """min/max exact (same products); plus 1e-5*max|y|."""
    S, x = _csr(np.float32, 1)
    jp = JSPR.build_plan(S.indptr, S.indices, S.data, S.shape)
    want = np.asarray(JSPR.spmv_route_monoid(jnp.asarray(x), jp, add=add,
                                             mul=mul, interpret=True))
    p, xt = _port(S, x)
    got = SPR.spmv_route_monoid(xt, p, add=add, mul=mul).numpy()
    if add == "plus":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)


def test_route_ds_vs_tpu_kernel():
    """fp64: the TPU kernel's double-single error class is ~5e-15; the
    port's native fp64 is held to 1e-12*max|y|."""
    S, x = _csr(np.float64, 2)
    jp = JSPR.build_plan(S.indptr, S.indices, S.data, S.shape)
    want = np.asarray(JSPR.spmv_route_ds(jnp.asarray(x), jp,
                                         interpret=True))
    p, xt = _port(S, x)
    got = SPR.spmv_route_ds(xt, p).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
