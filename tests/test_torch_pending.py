"""Port parity: non-blocking mode (the pending queue, Matrix.wait and
build.apply_pending), element access (ops/element.py), the iterators
(core/iterator.py) and execution contexts (core/context.py), against
graphblas_tpu."""

import threading

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.core import iterator as JI
from graphblas_tpu_torch import testing as GT
from graphblas_tpu_torch.core import iterator as TI
from torch_parity import (assert_same, cpu_default, to_port,  # noqa: F401
                          xla_path)

pytestmark = pytest.mark.usefixtures("xla_path")

SHAPE = (30, 22)
FMTS = ["sparse", "hyper", "bitmap", "full"]


def _matrix(rng, fmt, orient="row", dtype=np.float64, density=0.25):
    """(JAX, port) pair in ``fmt``: a fixed random pattern, small integer
    values from ``rng`` (FULL: every entry present)."""
    m, n = SHAPE
    if fmt == "full":
        A = gb.Matrix.from_dense(rng.integers(1, 9, SHAPE).astype(dtype))
        A = A.to_format(gb.FULL, orient)
    else:       # one pattern a density: the JAX side compiles it once
        S = sps.random(m, n, density, format="csr",
                       random_state=np.random.default_rng(100))
        S.data = rng.integers(1, 9, S.nnz).astype(dtype)
        A = gb.Matrix.from_scipy(S, orient=orient).to_format(fmt, orient)
    return A, to_port(A)


def _apply_events(M, events):
    for op, i, j, v in events:
        if op == "set":
            M.set_element(i, j, v)
        else:
            M.remove_element(i, j)


@pytest.mark.parametrize("fmt,orient", [("sparse", "row"), ("hyper", "col"),
                                        ("bitmap", "row"), ("full", "col"),
                                        ("sparse", "col")])
def test_set_remove_wait_every_format(fmt, orient):
    """The same events through both packages give the same matrix and
    format: sets on stored and new entries with repeats, removes of
    stored, queued and absent entries, the last event per entry
    winning."""
    rng = np.random.default_rng(FMTS.index(fmt))
    Aj, At = _matrix(rng, fmt, orient)
    v0, p0 = (t.numpy() for t in At.to_dense_pair())
    events = GT.pending_events(rng, SHAPE, 60, 20, np.argwhere(p0))
    _apply_events(Aj, events)
    _apply_events(At, events)
    assert At._pending and At.fmt == fmt
    At.wait()
    Aj.wait()
    assert not At._pending and At.fmt == Aj.fmt
    assert_same(Aj, At)
    _check_events(At, v0, p0, events)


def _check_events(At, v0, p0, events):
    """At equals ``events`` applied in order to the dense (v0, p0)."""
    r, c = np.nonzero(p0)
    r, c, v = GT.apply_events(r, c, v0[r, c], events, p0.shape)
    got_v, got_p = (t.numpy() for t in At.to_dense_pair())
    want_p = np.zeros_like(p0)
    want_p[r, c] = True
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_v[r, c], v)


def test_many_events_on_a_hypersparse_vector():
    """Hundreds of events, most on a few entries, on a HYPER matrix: the
    same as applying them in order."""
    rng = np.random.default_rng(5)
    _, At = _matrix(rng, "hyper", density=0.02)
    v0, p0 = (t.numpy() for t in At.to_dense_pair())
    events = GT.pending_events(rng, SHAPE, 300, 120, np.argwhere(p0))
    _apply_events(At, events)
    At.wait()
    assert At.fmt == "hyper"
    _check_events(At, v0, p0, events)


def test_last_event_wins_and_blocking_mode():
    A = gt.Matrix.new(gt.types.INT32, 4, 4)
    A.set_element(1, 2, 5)
    A.set_element(1, 2, 7)
    A.remove_element(1, 2)
    A.set_element(1, 2, 9)
    A.set_element(3, 3, 1)
    A.remove_element(3, 3)
    assert len(A._pending) == 6
    assert A.nvals == 1 and A.extract_element(1, 2) == 9
    old = gt.get_option("blocking")
    gt.init("blocking")
    try:
        B = gt.Matrix.new(gt.types.FP32, 3, 3)
        B.set_element(0, 1, 2.5)
        assert not B._pending and B.extract_element(0, 1) == 2.5
    finally:
        gt.init("blocking" if old else "nonblocking")


def test_bounds_checked_when_queued_and_no_value():
    A = gt.Matrix.new(gt.types.FP64, 3, 4)
    with pytest.raises(gt.errors.IndexOutOfBounds):
        A.set_element(3, 0, 1.0)
    with pytest.raises(gt.errors.IndexOutOfBounds):
        A.remove_element(0, 4)
    assert not A._pending
    A.set_element(0, 0, 1.0)
    with pytest.raises(gt.errors.NoValue):
        A.extract_element(1, 1)
    with pytest.raises(gt.errors.InvalidIndex):
        A.extract_element(5, 1)
    v = gt.Vector.new(gt.types.INT64, 5)
    v.set_element(2, 7)
    v.remove_element(2)
    with pytest.raises(gt.errors.NoValue):
        v.extract_element(2)
    assert not v.is_stored_element(2) and v.nvals == 0


@pytest.mark.parametrize("fmt,dtype", [("sparse", np.float32),
                                       ("sparse", np.uint64),
                                       ("bitmap", np.complex128),
                                       ("bitmap", np.bool_)])
def test_same_queue_both_packages(fmt, dtype):
    """One queue of numpy (rows, cols, value, dup) tuples handed to both
    packages (through interop) gives the same matrix after wait()."""
    rng = np.random.default_rng(7)
    Aj, _ = _matrix(rng, fmt, dtype=dtype)
    queue = [(np.array([1, 4, 1]), np.array([2, 3, 2]),
              np.array([5, 6, 7], dtype), "second"),
             (np.array([4]), np.array([3]), None, "delete"),
             (np.array([0, 29]), np.array([0, 21]),
              np.array(2 ** 63 + 5 if dtype == np.uint64 else 3, dtype),
              "second")]
    for r, c, v, dup in queue:
        Aj._add_pending(r, c, v, dup)
    At = gt.interop.matrix_from_arrays(
        Aj.shape, Aj.dtype.name, Aj.fmt, Aj.orient, *(
            None if a is None else np.asarray(a) for a in
            (Aj.indptr, Aj.h, Aj.indices, Aj.values, Aj.bitmap)),
        Aj.iso, device="cpu", pending=Aj._pending)
    assert len(At._pending) == 3
    assert_same(Aj.wait(), At.wait())


@pytest.mark.parametrize("fmt", FMTS)
def test_element_access_every_format(fmt):
    rng = np.random.default_rng(8)
    Aj, At = _matrix(rng, fmt, "col" if fmt == "hyper" else "row",
                     density=0.05 if fmt == "hyper" else 0.25)
    for i in range(0, SHAPE[0], 3):
        for j in range(0, SHAPE[1], 2):
            assert At.is_stored_element(i, j) == Aj.is_stored_element(i, j)
            if Aj.is_stored_element(i, j):
                assert At.extract_element(i, j) == Aj.extract_element(i, j)
            else:
                with pytest.raises(gt.errors.NoValue):
                    At.extract_element(i, j)


def test_iterators_match():
    """Entry iterator in storage order, row and column iterators, as the
    JAX package's; each waits first."""
    rng = np.random.default_rng(9)
    Aj, At = _matrix(rng, "sparse", "col")
    gone = np.argwhere(At.to_dense_pair()[1].numpy())[3]
    for M in (Aj, At):
        M.set_element(0, 0, 42.0)
        M.remove_element(*gone)
    ej, et = list(JI.EntryIterator(Aj)), list(TI.EntryIterator(At))
    assert et == ej
    it = TI.EntryIterator(At)
    assert it.pmax == len(ej) and it.seek(2)
    assert (it.getrow(), it.getcol(), it.getvalue()) == ej[2]
    for J, Tr in ((JI.RowIterator(Aj), TI.RowIterator(At)),
                  (JI.ColIterator(Aj), TI.ColIterator(At))):
        for (a, ia, va), (b, ib, vb) in zip(J, Tr):
            assert a == b
            np.testing.assert_array_equal(ib, np.asarray(ia))
            np.testing.assert_array_equal(vb, np.asarray(va))


def test_context_nesting_across_threads():
    """Contexts are thread-local, nest with ``with`` and restore; an
    unengaged thread sees the "world" context, which names no device."""
    seen = {}
    go = threading.Barrier(2, timeout=30)

    def worker(tag):
        with gt.Context(name=tag) as outer:
            go.wait()
            with gt.Context(device="cpu", name=tag * 2):
                seen[tag + "/inner"] = gt.context.current().name
            seen[tag] = gt.context.current() is outer
        seen[tag + "/after"] = gt.context.current().name
        seen[tag + "/device"] = gt.context.current().device

    ts = [threading.Thread(target=worker, args=(t,)) for t in ("a", "b")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
        assert not t.is_alive()
    assert seen == {"a/inner": "aa", "b/inner": "bb", "a": True, "b": True,
                    "a/after": "world", "b/after": "world",
                    "a/device": None, "b/device": None}
    ctx = gt.Context(device="cpu").engage()
    try:
        x = gt.context.device_put_ctx(torch.ones(2))
        assert x.device.type == "cpu" and gt.context.current() is ctx
    finally:
        ctx.disengage()


def test_wait_rebinds_new_tensors():
    """wait() never writes into the tensors the matrix held (plans and
    caches keyed on them stay valid): the old ones keep their values."""
    rng = np.random.default_rng(10)
    for fmt in ("sparse", "bitmap"):
        _, At = _matrix(rng, fmt)
        held = [t for t in (At.indptr, At.indices, At.values, At.bitmap)
                if t is not None]
        before = [t.clone() for t in held]
        stored = np.argwhere(At.to_dense_pair()[1].numpy())[0]
        At.set_element(*stored, 99.0)
        At.set_element(0, 1, -3.0)
        At.wait()
        for t, b in zip(held, before):
            assert torch.equal(t, b)
        assert At.extract_element(*stored) == 99.0


def _ops(A, B, u):
    """Every ported api op on operands (A square, u a Vector)."""
    sr, ops = gt.semiring.PLUS_TIMES, gt.operators
    return {
        "ewise_add": lambda: gt.ewise_add(A, B, ops.PLUS),
        "ewise_mult": lambda: gt.ewise_mult(A, B, ops.TIMES),
        "ewise_union": lambda: gt.ewise_union(A, 1.0, B, 2.0, ops.MINUS),
        "apply": lambda: gt.apply(A, ops.AINV),
        "select": lambda: gt.select(A, ops.TRIL, 0),
        "reduce": lambda: gt.reduce(A, gt.monoid.PLUS),
        "reduce_scalar": lambda: gt.reduce_scalar(A, gt.monoid.MAX),
        "transpose": lambda: gt.transpose(A),
        "mxm": lambda: gt.mxm(A, B, sr),
        "mxv": lambda: gt.mxv(A, u, sr),
        "vxm": lambda: gt.vxm(u, A, sr),
        "vxm_chain": lambda: gt.vxm_chain(u, A, sr, 2),
        "mxm_reduce_scalar": lambda: gt.mxm_reduce_scalar(
            A, B, gt.semiring.PLUS_PAIR, mask=A,
            desc=gt.Descriptor(mask_structure=True)),
        "masked_ewise": lambda: gt.ewise_add(A, B, ops.PLUS, mask=B),
    }


def _same(x, y):
    if isinstance(x, gt.Matrix):
        vx, px = (t.numpy() for t in x.to_dense_pair())
        vy, py = (t.numpy() for t in y.to_dense_pair())
        np.testing.assert_array_equal(px, py)
        np.testing.assert_array_equal(vx[px], vy[py])
    elif isinstance(x, torch.Tensor):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    else:
        assert x == y


def test_every_api_op_waits_first():
    """Each api op on operands with events still queued equals the op on
    the same operands already finalised."""
    rng = np.random.default_rng(11)
    S = sps.random(20, 20, 0.2, random_state=rng, format="csr")
    S.data = rng.integers(1, 9, S.nnz).astype(np.float32)
    T = sps.random(20, 20, 0.2, random_state=rng, format="csr")
    T.data = rng.integers(1, 9, T.nnz).astype(np.float32)
    x = rng.integers(1, 5, 20).astype(np.float32)
    events = GT.pending_events(rng, (20, 20), 30, 10,
                               stored=np.argwhere(S.toarray() != 0))

    def operands(wait):
        A, B = gt.Matrix.from_scipy(S), gt.Matrix.from_scipy(T)
        u = gt.Vector.from_dense(torch.from_numpy(x))
        _apply_events(A, events)
        _apply_events(B, events[::-1])
        u.set_element(3, 9.0)
        u.remove_element(5)
        if wait:
            for M in (A, B, u):
                M.wait()
        return A, B, u

    ref = {k: f() for k, f in _ops(*operands(True)).items()}
    for name in ref:
        A, B, u = operands(False)
        assert A._pending and B._pending and u._pending
        _same(_ops(A, B, u)[name](), ref[name])
