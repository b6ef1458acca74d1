"""Port parity: the object model — build, formats, conversions, conform,
apply, reduce (graphblas_tpu_torch.core / ops against graphblas_tpu)."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu_torch.core import errors as TE
from graphblas_tpu_torch.core import monoid as TM
from graphblas_tpu_torch.core import ops as TO
from graphblas_tpu_torch.core.convert import conform as t_conform
from graphblas_tpu.core.convert import conform as j_conform
from torch_parity import (assert_same, cpu_default, pair,  # noqa: F401
                          random_csr, to_port, vec_pair, xla_path)

M, N = 37, 29


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _arrays_equal(Aj, At):
    assert (Aj.shape, Aj.fmt, Aj.orient, Aj.iso) == \
        (At.shape, At.fmt, At.orient, At.iso)
    for f in ("indptr", "h", "indices", "values", "bitmap"):
        a, b = getattr(Aj, f), getattr(At, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(_np(b), np.asarray(a), err_msg=f)


@pytest.mark.parametrize("dup", ["plus", "first", "second", "min", "max",
                                 "times"])
def test_build_with_dup_matches(dup):
    rng = np.random.default_rng(1)
    r = rng.integers(0, M, 400)
    c = rng.integers(0, N, 400)
    v = rng.integers(-5, 6, 400).astype(np.int64)
    for orient in ("row", "col"):
        Aj = gb.Matrix.from_coo(r, c, v, (M, N), dup=dup, orient=orient)
        At = gt.Matrix.from_coo(r, c, v, (M, N), dup=dup, orient=orient)
        At.check()
        _arrays_equal(Aj, At)


def test_build_errors_and_iso():
    with pytest.raises(TE.IndexOutOfBounds):
        gt.Matrix.from_coo([0, M], [0, 0], [1.0, 2.0], (M, N))
    with pytest.raises(TE.DimensionMismatch):
        gt.Matrix.from_coo([0, 1], [0, 1], [1.0, 2.0, 3.0], (M, N))
    A = gt.Matrix.from_coo([3, 1, 3], [2, 0, 2], 7.0, (M, N), iso=True)
    assert A.iso and A.nvals == 2 and A.dtype is gt.types.FP64
    v = gt.Vector.from_coo([4, 1], [2.5, 1.5], 9)
    assert v.size == 9 and v.nvals == 2
    s = gt.Scalar.from_value(3, dtype=gt.types.INT32)
    assert s.value() == 3 and not s.is_empty


FORMATS = [(f, o) for f in ("hyper", "sparse", "bitmap", "full")
           for o in ("row", "col")]


@pytest.mark.parametrize("fmt,orient", FORMATS)
def test_to_format_matches(fmt, orient):
    """All 8 formats, from a CSR source and back; exact arrays."""
    rng = np.random.default_rng(2)
    S = random_csr(rng, M, N, 0.9 if fmt == "full" else 0.12,
                   np.float64)
    if fmt == "full":
        S = S.toarray() + 1.0
        Aj = gb.Matrix.from_dense(S)
        At = gt.Matrix.from_dense(S)
    else:
        Aj, At = pair(S)
    Bj, Bt = Aj.to_format(fmt, orient), At.to_format(fmt, orient)
    Bt.check()
    _arrays_equal(Bj, Bt)
    _arrays_equal(Bj.to_format("sparse", "row"),
                  Bt.to_format("sparse", "row"))
    np.testing.assert_array_equal(Bt.to_scipy().toarray(),
                                  Bj.to_scipy().toarray())


def test_interop_round_trip_every_format():
    rng = np.random.default_rng(3)
    S = random_csr(rng, M, N, 0.2, np.float32)
    Aj = gb.Matrix.from_scipy(S)
    for fmt, orient in FORMATS[:6]:
        Bj = Aj.to_format(fmt, orient)
        Bt = to_port(Bj)
        Bt.check()
        _arrays_equal(Bj, Bt)
    uj = gb.Vector.from_dense_masked(np.arange(9.0), np.arange(9) % 2 == 0)
    ut = to_port(uj)
    assert isinstance(ut, gt.Vector) and ut.nvals == 5
    assert_same(uj, ut)


def test_check_catches_broken_storage():
    rng = np.random.default_rng(4)
    _, At = pair(random_csr(rng, M, N, 0.2))
    At.check()
    bad = At.dup()
    bad.indices = bad.indices.flip(0)
    with pytest.raises(TE.InvalidObject):
        bad.check()
    bad = At.dup()
    bad.indptr = bad.indptr.clone()
    bad.indptr[-1] += 1
    with pytest.raises(TE.InvalidObject):
        bad.check()


def test_conform_matches():
    """Bitmap/sparse/hyper switching on a target with known nvals."""
    rng = np.random.default_rng(5)
    for density in (0.01, 0.3, 1.0):
        S = random_csr(rng, M, N, density, np.float64)
        Aj, At = pair(S)
        Aj, At = Aj.to_format("bitmap"), At.to_format("bitmap")
        Aj.nvals, At.nvals           # cache the count: conform may act
        Cj, Ct = j_conform(Aj), t_conform(At)
        assert Cj.fmt == Ct.fmt
        assert_same(Cj, Ct)


def test_vector_constructors_take_device():
    x = np.arange(5, dtype=np.float32)
    v = gt.Vector.from_dense(x, device="cpu")
    assert v.fmt == "full" and v.device.type == "cpu"
    w = gt.Vector.from_dense(torch.from_numpy(x))
    assert w.device == v.device
    e = gt.Vector.new(gt.types.BOOL, 7, fmt="bitmap", device="cpu")
    assert e.nvals == 0 and e.values.dtype == torch.bool
    m = gt.Vector.from_dense_masked(x, x > 1)
    assert m.nvals == 3
    A = gt.Matrix.new(gt.types.FP32, 3, 4)
    assert A.nvals == 0 and A.indptr.shape[0] == 4
    assert gt.Matrix.from_scipy(random_csr(np.random.default_rng(0), 4, 4,
                                           0.5)).astype(gt.types.FP64
                                                        ).dtype.name == \
        "GrB_FP64"


def test_default_device_is_the_card(monkeypatch):
    """Without ``device`` the constructors and entry points resolve to the
    card (the ``device`` option defaults to "cuda") and raise where torch
    sees none; nothing lands on the CPU unless asked.  No card memory is
    touched: torch.cuda.is_available is replaced for the test."""
    from graphblas_tpu_torch import entry, interop
    from graphblas_tpu_torch.core import config as CFG
    from graphblas_tpu_torch.ops import build
    assert CFG._Global().device == "cuda"
    gt.set_option("device", "cuda")   # the package default
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert CFG.default_device() == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    S = random_csr(np.random.default_rng(1), 4, 4, 0.5)
    x = np.ones(3, np.float32)
    makers = [
        lambda: gt.Matrix.from_scipy(S),
        lambda: gt.Matrix.from_coo([0], [1], [1.0], (2, 2)),
        lambda: gt.Matrix.from_dense(np.ones((2, 2))),
        lambda: gt.Matrix.from_dense_masked(np.ones((2, 2)),
                                            np.ones((2, 2), bool)),
        lambda: gt.Matrix.new(gt.types.FP32, 3, 4),
        lambda: gt.Matrix((3, 4), gt.types.FP32),
        lambda: gt.Vector.new(gt.types.BOOL, 7, fmt="bitmap"),
        lambda: gt.Vector.from_coo([1], [2.0], 3),
        lambda: gt.Vector.from_dense(x),
        lambda: gt.Scalar.from_value(1.5),
        lambda: build.build_matrix(gt.Matrix, [0], [0], [1.0], (1, 1), None,
                                   "plus", None, False),
        lambda: interop.matrix_from_arrays(
            (4, 4), "GrB_FP32", "sparse", "row", S.indptr, None, S.indices,
            S.data, None, False),
        lambda: interop.vector_from_arrays(3, "GrB_FP32", "full", None, None,
                                           None, x[:, None], None, False),
        lambda: entry.entry(),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
    # the CPU when asked for; a tensor keeps its own device
    assert gt.Matrix.from_scipy(S, device="cpu").device.type == "cpu"
    assert gt.Vector.from_dense(torch.from_numpy(x)).device.type == "cpu"
    gt.set_option("device", "cpu")
    assert gt.Matrix.from_scipy(S).device.type == "cpu"


APPLY = [("AINV", None), ("ONE", None), ("TIMES", ("second", 2.5)),
         ("MINUS", ("first", 1.0)), ("POSITIONJ", None), ("TRIL", 0),
         ("VALUEGT", 0.0)]


@pytest.mark.parametrize("opname,arg", APPLY)
def test_apply_matches(opname, arg):
    rng = np.random.default_rng(6)
    S = random_csr(rng, M, N, 0.2, np.float64)
    for fmt in ("sparse", "bitmap"):
        Aj = gb.Matrix.from_scipy(S).to_format(fmt)
        At = to_port(Aj)
        jop, top = getattr(gb.operators, opname), getattr(TO, opname)
        if isinstance(top, gt.IndexUnaryOp):
            Rj = gb.apply(Aj, jop, thunk=arg)
            Rt = gt.apply(At, top, thunk=arg)
        elif isinstance(top, gt.BinaryOp):
            Rj = gb.apply(Aj, jop, bind=arg)
            Rt = gt.apply(At, top, bind=arg)
        else:
            Rj, Rt = gb.apply(Aj, jop), gt.apply(At, top)
        assert Rj.dtype.name == Rt.dtype.name
        assert_same(Rj, Rt)


@pytest.mark.parametrize("mon", ["PLUS", "MIN", "MAX", "TIMES", "LOR"])
def test_reduce_matches(mon):
    """Row reduce to a vector and full reduce to a scalar.  Exact on
    integer values (no rounding in any order), except the TIMES scalar:
    the product of all 151 entries exceeds 2^53 and rounds, so it is held
    to rtol 1e-12."""
    rng = np.random.default_rng(7)
    S = random_csr(rng, M, N, 0.15, np.float64, integer=True)
    for fmt in ("sparse", "bitmap"):
        Aj = gb.Matrix.from_scipy(S).to_format(fmt)
        At = to_port(Aj)
        jm, tm = getattr(gb.monoid, mon), getattr(TM, mon)
        assert_same(gb.reduce(Aj, jm), gt.reduce(At, tm))
        np.testing.assert_allclose(gt.reduce_scalar(At, tm),
                                   gb.reduce_scalar(Aj, jm),
                                   rtol=1e-12 if mon == "TIMES" else 0)


def test_transpose_and_writeback_paths():
    """Logical transpose, and C<M> = accum(C, A') through both writeback
    paths (sparse merge, dense)."""
    rng = np.random.default_rng(8)
    S = random_csr(rng, M, M, 0.2, np.float64)
    Aj, At = pair(S)
    assert_same(gb.transpose(Aj), gt.transpose(At))
    Cs = random_csr(rng, M, M, 0.2, np.float64)
    Ms = random_csr(rng, M, M, 0.3, np.float64)
    for cfmt in ("sparse", "bitmap"):
        Cj = gb.Matrix.from_scipy(Cs).to_format(cfmt)
        Ct = to_port(Cj)
        Mj, Mt = pair(Ms)
        d = gb.Descriptor(replace=True, mask_structure=True)
        dt = gt.Descriptor(replace=True, mask_structure=True)
        Rj = gb.transpose(Aj, C=Cj, mask=Mj, accum=gb.operators.PLUS,
                          desc=d)
        Rt = gt.transpose(At, C=Ct, mask=Mt, accum=TO.PLUS, desc=dt)
        assert_same(Rj, Rt)
