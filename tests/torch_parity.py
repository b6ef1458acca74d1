"""Parity helpers for the PyTorch port's tests: build each operand in the
JAX package from numpy inputs made from a seed, carry it to the port
through ``graphblas_tpu_torch.interop`` (numpy arrays only), and compare
the two results as dense (values, present) pairs."""

import numpy as np
import pytest
import scipy.sparse as sps

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu_torch import interop


@pytest.fixture(autouse=True)
def cpu_default():
    """The port's constructors put tensors on the card unless told
    otherwise; its CPU tests ask for the CPU (each test module imports
    this autouse fixture)."""
    old = gt.get_option("device")
    gt.set_option("device", "cpu")
    yield
    gt.set_option("device", old)


@pytest.fixture
def xla_path():
    """Run the JAX side on its XLA path (no Pallas kernels), as its own
    fast tests do on the CPU; the option is global, so restore it."""
    old = gb.get_option("pallas_enabled")
    gb.set_option("pallas_enabled", False)
    yield
    gb.set_option("pallas_enabled", old)


def _np(a):
    return None if a is None else np.asarray(a)


def to_port(M, device="cpu"):
    """The port's copy of a JAX Matrix/Vector, built from its arrays."""
    args = (M.dtype.name, M.fmt, _np(M.indptr), _np(M.h),
            _np(M.indices), _np(M.values), _np(M.bitmap), M.iso)
    if isinstance(M, gb.Vector):
        return interop.vector_from_arrays(M.nrows, *args, device=device)
    return interop.matrix_from_arrays(M.shape, M.dtype.name, M.fmt,
                                      M.orient, *args[2:], device=device)


def dense_jax(M):
    v, p = M.to_dense_pair()
    return np.asarray(v), np.asarray(p)


def dense_port(M):
    v, p = M.to_dense_pair()
    return v.cpu().numpy(), p.cpu().numpy()


def assert_same(Mj, Mt, rtol=0.0, scale_tol=None):
    """Same shape and pattern; values equal (``rtol=0``, exact) or within
    ``scale_tol * max|y|`` (summation-order differences)."""
    vj, pj = dense_jax(Mj)
    vt, pt = dense_port(Mt)
    assert vj.shape == vt.shape
    np.testing.assert_array_equal(pj, pt)
    a, b = vj[pj], vt[pt]
    if scale_tol is None:
        np.testing.assert_array_equal(a, b)
    else:
        bound = scale_tol * float(np.abs(a).max(initial=0.0))
        assert float(np.abs(a.astype(np.float64) - b).max(initial=0.0)) \
            <= bound


def random_csr(rng, m, n, density, dtype=np.float32, integer=False):
    """Random scipy CSR (duplicates summed) with normal or small-integer
    values."""
    nnz = max(1, int(m * n * density))
    r = rng.integers(0, m, nnz)
    c = rng.integers(0, n, nnz)
    v = (rng.integers(1, 10, nnz) if integer
         else rng.standard_normal(nnz)).astype(dtype)
    S = sps.csr_matrix((v, (r, c)), shape=(m, n))
    S.sum_duplicates()
    return S


def pair(S, dtype=None, orient="row"):
    """(JAX Matrix, port Matrix) of one scipy matrix."""
    A = gb.Matrix.from_scipy(S, orient=orient, dtype=dtype)
    return A, to_port(A)


def vec_pair(x, present=None):
    """(JAX Vector, port Vector): FULL when present is None, else
    BITMAP."""
    if present is None:
        u = gb.Vector.from_dense(x)
    else:
        u = gb.Vector.from_dense_masked(x, present)
    return u, to_port(u)


def sparse_operand(rng, m, n, density, kind):
    """Random scipy CSR of ``kind`` f32 (normal), bool, i32 or i64 (small
    integers), duplicates summed."""
    nnz = max(1, int(m * n * density))
    r, c = rng.integers(0, m, nnz), rng.integers(0, n, nnz)
    if kind == "f32":
        v = rng.standard_normal(nnz).astype(np.float32)
    elif kind == "bool":
        v = np.ones(nnz, np.bool_)
    else:
        v = rng.integers(1, 9, nnz).astype(np.int32 if kind == "i32"
                                           else np.int64)
    S = sps.csr_matrix((v, (r, c)), shape=(m, n))
    S.sum_duplicates()
    return S


def wide_operands(rng, masked):
    """A short A (200 rows) times B with n = 2^23 columns: the wide
    two-plane keys (K8)."""
    n = 1 << 23
    ra = np.repeat(np.arange(200), 6)
    ca = rng.integers(0, 3000, ra.size)
    A = sps.csr_matrix((rng.integers(1, 5, ra.size).astype(np.float32),
                        (ra, ca)), shape=(200, n))
    rb = rng.integers(0, 3000, 4000)
    cb = np.concatenate([rng.integers(0, 50, 2000),
                         rng.integers(n - 50, n, 2000)])
    B = sps.csr_matrix((rng.integers(1, 5, rb.size).astype(np.float32),
                        (rb, cb)), shape=(n, n))
    A.sum_duplicates()
    B.sum_duplicates()
    M = None
    if masked:
        C = (A @ B).tocoo()
        sel = rng.random(C.nnz) < 0.5
        M = sps.csr_matrix((np.ones(sel.sum(), np.float32),
                            (C.row[sel], C.col[sel])), shape=(200, n))
    return A, B, M


def tc_graph(rng, n=200, deg=6):
    """A random directed pattern graph (values 1)."""
    S = sps.csr_matrix((np.ones(n * deg, np.float32),
                        (rng.integers(0, n, n * deg),
                         rng.integers(0, n, n * deg))), shape=(n, n))
    S.sum_duplicates()
    S.data[:] = 1
    return S


def tc_scipy(S):
    """sum((L L') .* L) with L = tril(S, -1) on the pattern (scipy)."""
    L = sps.tril(S, -1).tocsr()
    L.data[:] = 1
    return int((L @ L.T).multiply(L).sum())


__all__ = ["gt", "gb", "cpu_default", "xla_path", "to_port", "dense_jax", "dense_port",
           "assert_same", "random_csr", "pair", "vec_pair", "sparse_operand",
           "wide_operands", "tc_graph", "tc_scipy"]
