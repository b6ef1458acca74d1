"""Port parity: the CSR <-> CSC reorient (``core/convert.py``
``_sparse_reorient``), whose row ids and values go through K9
(``kernels/static_route.permute_rows``; its plain version on the CPU),
held bitwise against the JAX package's ``to_format`` on the same
seed-made matrices, one per value type the port stores (1, 2, 4, 8 and 16
bytes, a struct row) and an iso matrix; and a spy showing which K9 entry
the reorient calls, with how many payloads."""

import numpy as np
import pytest
import torch

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.core import types as JT
from graphblas_tpu_torch import testing as GT
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
