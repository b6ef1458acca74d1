"""Port parity: the CSR <-> CSC reorient (``core/convert.py``
``_sparse_reorient``), whose row ids and values go through K9
(``kernels/static_route.permute_rows``; its plain version on the CPU),
held bitwise against the JAX package's ``to_format`` on the same
seed-made matrices, one per value type the port stores (1, 2, 4, 8 and 16
bytes, a struct row) and an iso matrix; a spy showing which K9 entry
the reorient calls, with how many payloads; and the flip kept with the
matrix (``convert._reorients``): found again while the arrays live and
are unwritten, flipped anew after an in-place write to the source or to
the flip, and gone with the source."""

import gc

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.core import types as JT
from graphblas_tpu_torch import testing as GT
from graphblas_tpu_torch.core import convert as CV
from graphblas_tpu_torch.core import types as TT
from graphblas_tpu_torch.kernels import static_route as STR
from torch_parity import cpu_default, to_port  # noqa: F401

PAIR = (JT.struct_type("ReorientPair", np.int64, (2,)),
        TT.struct_type("ReorientPair", np.int64, (2,)))
TYPES = {"BOOL": "bool", "INT8": "int8", "INT16": "int16", "FP32": "fp32",
         "FP64": "fp64", "UINT64": "uint64", "FC64": "fc64",
         "struct": "int64x2", "iso": "fp32"}


def _pair(kind, rng):
    """(JAX, port) 70 x 50 matrix stored by row, ~700 entries with
    duplicates kept first, values of ``kind`` (a key of TYPES)."""
    m, n, k = 70, 50, 800
    r, c = rng.integers(0, m, k), rng.integers(0, n, k)
    vals = GT.k9_payload(rng, k, TYPES[kind]).numpy()
    iso = kind == "iso"
    jty = PAIR[0] if kind == "struct" else \
        getattr(JT, "FP32" if iso else kind)
    Aj = gb.Matrix.from_coo(r, c, vals[0] if iso else vals, (m, n),
                            dtype=jty, dup="first", orient="row", iso=iso)
    return Aj, to_port(Aj)


def _arrays(M):
    return [np.asarray(a) if not isinstance(a, torch.Tensor)
            else a.numpy() for a in (M.indptr, M.indices, M.values)]


def _assert_bitwise(Mj, Mt):
    for a, b in zip(_arrays(Mj), _arrays(Mt)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("kind", list(TYPES))
def test_reorient_matches_jax(kind):
    Aj, At = _pair(kind, np.random.default_rng(60))
    assert At.iso == (kind == "iso") and At.orient == gt.ROW
    Cj, Ct = Aj.to_format(gb.SPARSE, gb.COL), At.to_format(gt.SPARSE, gt.COL)
    assert Ct.orient == gt.COL
    _assert_bitwise(Cj, Ct)
    _assert_bitwise(Cj.to_format(gb.SPARSE, gb.ROW),
                    Ct.to_format(gt.SPARSE, gt.ROW))
    _assert_bitwise(Aj, Ct.to_format(gt.SPARSE, gt.ROW))


@pytest.mark.parametrize("kind", ["FP32", "iso"])
def test_reorient_calls_k9(kind, monkeypatch):
    """The reorient gathers through ``permute_rows`` once: the row ids and
    the values as two payloads, the row ids alone when the values are
    iso; it makes no other gather of them."""
    _, At = _pair(kind, np.random.default_rng(61))
    calls = []
    real = STR.permute_rows

    def spy(x, perm, *more):
        calls.append((x.dtype, perm.dtype, [t.dtype for t in more]))
        return real(x, perm, *more)

    monkeypatch.setattr(STR, "permute_rows", spy)
    Ct = At.to_format(gt.SPARSE, gt.COL)
    more = [] if kind == "iso" else [torch.float32]
    assert calls == [(torch.int32, torch.int64, more)]
    assert Ct.iso == (kind == "iso")


@pytest.fixture
def counted():
    """No kept flip, tracing on from empty counters; the counters, read
    after each step, are what the fixture returns."""
    CV._reorients.clear()
    gt.trace_reset()
    gt.set_option("trace", True)

    def counts():
        c = gt.trace_counters()
        return c.get("convert.reorients", 0), \
            c.get("convert.reorient_hits", 0)

    try:
        yield counts
    finally:
        gt.set_option("trace", False)
        gt.trace_reset()
        CV._reorients.clear()


def _jax_of(At):
    """The JAX package's copy of a port matrix stored by row (FP32), its
    arrays adopted as they are."""
    from graphblas_tpu.ops import serialize as JS
    indptr, indices, values = _arrays(At)
    return JS.pack(At.shape, JT.FP32, "sparse", "row", indptr=indptr,
                   indices=indices, values=values, trusted=True)


def _same_arrays(M, N):
    return all(a is b for a, b in zip((M.indptr, M.indices, M.values),
                                      (N.indptr, N.indices, N.values)))


@pytest.mark.parametrize("kind", ["FP32", "iso"])
def test_reorient_kept_with_the_matrix(kind, counted):
    """Two flips of one matrix: one reorient, then the same arrays again;
    the kept flip goes once the matrix is freed (an iso flip shares the
    matrix's value, which must not keep the entry alive)."""
    Aj, At = _pair(kind, np.random.default_rng(60))
    C1 = At.to_format(gt.SPARSE, gt.COL)
    assert counted() == (1, 0)
    C2 = At.to_format(gt.SPARSE, gt.COL)
    assert counted() == (1, 1)
    assert C2 is not C1 and _same_arrays(C1, C2)
    assert C2.orient == gt.COL and C2.shape == At.shape
    assert C2.iso == (kind == "iso")
    _assert_bitwise(Aj.to_format(gb.SPARSE, gb.COL), C2)
    assert len(CV._reorients) == 1
    del At, C1, C2
    gc.collect()
    assert len(CV._reorients) == 0


def _write_values(At, C):
    At.values.mul_(2)


def _write_indices(At, C):
    """Move the last entry of a row whose last column is not the last
    one column right: the matrix stays valid."""
    indptr, indices, _ = _arrays(At)
    ends = indptr[1:][np.diff(indptr) > 0] - 1
    k = int(ends[indices[ends] < At.ncols - 1][0])
    At.indices[k] += 1


def _set_element(At, C):
    At.set_element(3, 7, 2.5)
    At.wait()


def _write_flip(At, C):
    C.values.mul_(2)


WRITES = {"values": _write_values, "indices": _write_indices,
          "set_element": _set_element, "flip_values": _write_flip}


@pytest.mark.parametrize("write", list(WRITES))
def test_reorient_after_a_write_flips_again(write, counted):
    """An in-place write to the source's values or indices, pending
    tuples applied by wait(), or a write into the flip handed out: the
    next flip misses, matches the JAX package's flip of the matrix as it
    now is, and is found again by the flip after it."""
    _, At = _pair("FP32", np.random.default_rng(60))
    C1 = At.to_format(gt.SPARSE, gt.COL)
    WRITES[write](At, C1)
    Cj = _jax_of(At).to_format(gb.SPARSE, gb.COL)
    C2 = At.to_format(gt.SPARSE, gt.COL)
    assert counted() == (2, 0)
    assert C2.values is not C1.values
    _assert_bitwise(Cj, C2)
    C3 = At.to_format(gt.SPARSE, gt.COL)
    assert counted() == (2, 1) and _same_arrays(C2, C3)


def test_reorient_of_each_orientation_kept_apart(counted):
    """A stored by row and its logical transpose, stored by column, share
    their arrays: their flips are kept apart, each found again, each
    with its own orientation and shape."""
    from graphblas_tpu_torch.ops.transpose import logical_transpose
    Aj, At = _pair("FP32", np.random.default_rng(60))
    Tt = logical_transpose(At)
    assert Tt.orient == gt.COL and Tt.indices is At.indices
    Cj = Aj.to_format(gb.SPARSE, gb.COL)
    for _ in range(2):
        C = At.to_format(gt.SPARSE, gt.COL)
        D = Tt.to_format(gt.SPARSE, gt.ROW)
        assert (C.orient, C.shape) == (gt.COL, At.shape)
        assert (D.orient, D.shape) == (gt.ROW, Tt.shape)
        _assert_bitwise(Cj, C)
        _assert_bitwise(Cj, D)
    assert counted() == (2, 2) and len(CV._reorients) == 2
    assert C.values is not D.values


def test_reorient_of_inference_tensors_is_not_kept(counted):
    """Tensors made under torch.inference_mode keep no write counter, so
    their flips are made every time and never kept."""
    Aj, At = _pair("FP32", np.random.default_rng(60))
    with torch.inference_mode():
        Ai = gt.Matrix.from_coo(*(t.clone() for t in At.coo()), At.shape,
                                dup="first")
        assert Ai.indices.is_inference()
        C1 = Ai.to_format(gt.SPARSE, gt.COL)
        C2 = Ai.to_format(gt.SPARSE, gt.COL)
    assert counted() == (2, 0) and len(CV._reorients) == 0
    _assert_bitwise(Aj.to_format(gb.SPARSE, gb.COL), C2)
    assert not _same_arrays(C1, C2)


def test_host_arrays_share_no_storage(counted):
    """The arrays ``to_scipy`` hands out are copies even on the CPU: a
    write into them, which torch's write counter cannot see, leaves A and
    its kept flip as they were."""
    Aj, At = _pair("FP32", np.random.default_rng(60))
    before = [a.copy() for a in _arrays(At)]
    C1 = At.to_format(gt.SPARSE, gt.COL)
    S = At.to_scipy()
    S.data *= 2
    S.indices[:] = 0
    for a, b in zip(_arrays(At), before):
        np.testing.assert_array_equal(a, b)
    C2 = At.to_format(gt.SPARSE, gt.COL)
    assert counted() == (1, 1) and _same_arrays(C1, C2)
    _assert_bitwise(Aj.to_format(gb.SPARSE, gb.COL), C2)
