"""Cross-package serialize / deserialize and Matrix Market input: a blob
written by graphblas_tpu.ops.serialize loads in the port and the other
way round, bitwise, and the two packages write the same bytes for the
same matrix and codec (none, zlib, zstd where the module imports, and
gbz with both delta tags: ``gbd1`` with the native library, ``raw0``
without it).  ``from_mtx`` reads general, symmetric, skew-symmetric,
integer and pattern files the same in both packages.
"""

import numpy as np
import pytest

import graphblas_tpu as gb
import graphblas_tpu_torch as gt
from graphblas_tpu.ops import serialize as JS
from graphblas_tpu.utils import native as JNV
from graphblas_tpu_torch.ops import serialize as TS
from graphblas_tpu_torch.utils import native as TNV
from torch_parity import (assert_same, cpu_default, to_port,  # noqa: F401
                          typed_pair, xla_path)

pytestmark = pytest.mark.usefixtures("xla_path")

CODECS = ["none", "zlib", "gbz", "gbz-raw0"] + (
    ["zstd"] if "zstd" in TS._CODECS and "zstd" in JS._CODECS else [])

CASES = {
    "sparse-row-fp64": (np.float64, "sparse", "row", None),
    "hyper-col-int32": (np.int32, "hyper", "col", None),
    "bitmap-bool": (np.bool_, "bitmap", "row", None),
    "full-fp32": (np.float32, "full", "col", None),
    "sparse-uint64": (np.uint64, "sparse", "row", None),
    "bitmap-fc64": (np.complex128, "bitmap", "col", None),
    "vector-uint64": (np.uint64, "sparse", "col", gb.Vector),
    "vector-full-int8": (np.int8, "full", "col", gb.Vector),
}


def _codec(name, monkeypatch):
    """The codec name to pass; ``gbz-raw0`` runs gbz with neither
    package's native library."""
    if name == "gbz-raw0":
        monkeypatch.setattr(JNV, "_load", lambda: None)
        monkeypatch.setattr(TNV, "library", lambda: None)
        return "gbz"
    return name


def _pair(rng, case):
    dt, fmt, orient, klass = CASES[case]
    shape = (40, 1) if klass else (20, 15)
    return typed_pair(rng, shape, 0.3, dt, fmt, orient, which=80,
                      klass=klass)


def _delta_tags(blob):
    """The delta tags (``gbd1`` / ``raw0``) of a gbz blob's delta-coded
    arrays."""
    import struct
    import zlib
    pos = 8 + struct.unpack("<I", blob[4:8])[0]
    tags = set()
    for meta in TS.serialized_get(blob)["arrays"].values():
        raw = blob[pos:pos + meta["nbytes"]]
        pos += meta["nbytes"]
        if raw[:1] == b"D":
            tags.add(zlib.decompress(raw[1:])[:4])
    return tags


def _assert_fields(Tm, Jm):
    """Same class, metadata and arrays, bitwise."""
    assert type(Tm).__name__ == type(Jm).__name__
    assert (Tm.shape, Tm.dtype.name, Tm.fmt, Tm.orient, Tm.iso) == \
        (Jm.shape, Jm.dtype.name, Jm.fmt, Jm.orient, Jm.iso)
    for name in TS.ARRAYS:
        a, b = getattr(Tm, name), getattr(Jm, name)
        assert (a is None) == (b is None), name
        if a is not None:
            b = np.asarray(b)
            a = a.cpu().numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("case", list(CASES))
def test_blob_cross_load(rng, monkeypatch, case, codec):
    codec = _codec(codec, monkeypatch)
    Aj, At = _pair(rng, case)
    bj = JS.serialize(Aj, codec)
    bt = gt.serialize(At, codec)
    assert bj == bt
    if codec == "gbz":
        tag = b"raw0" if TNV.library() is None else b"gbd1"
        assert _delta_tags(bt) <= {tag}
    Tm = gt.deserialize(bj, device="cpu")
    _assert_fields(Tm, Aj)
    assert_same(Aj, Tm)
    Jm = JS.deserialize(bt)
    _assert_fields(At, Jm)
    assert_same(Jm, At)
    assert TS.serialized_get(bt) == JS.serialized_get(bj)


@pytest.mark.parametrize("codec", ["zlib", "gbz"])
def test_blob_iso(monkeypatch, codec):
    """An iso matrix keeps one value."""
    Aj = gb.Matrix.from_coo([0, 2, 3], [1, 1, 4], 7.5, (5, 6), iso=True)
    At = to_port(Aj)
    assert At.iso
    bt = gt.serialize(At, codec)
    assert bt == JS.serialize(Aj, codec)
    back = JS.deserialize(bt)
    assert back.iso and back.values.shape == (1,)
    assert_same(back, gt.deserialize(bt, device="cpu"))


def test_default_codec_and_level():
    """With no codec named, both packages pick the same one (zstd where
    the module imports, else zlib)."""
    Aj = gb.Matrix.from_coo([0], [1], [2.0], (2, 2))
    At = to_port(Aj)
    want = "zstd" if "zstd" in TS._CODECS else "zlib"
    assert TS.serialized_get(gt.serialize(At))["compression"] == want
    assert gt.serialize(At, level=3) == JS.serialize(Aj, level=3)
    with pytest.raises(gt.errors.InvalidValue):
        gt.serialize(At, "lz77")


def test_gbd1_needs_library(monkeypatch):
    At = gt.Matrix.from_coo([0, 1], [1, 0], [1.0, 2.0], (2, 2))
    blob = gt.serialize(At, "gbz")
    if TNV.library() is None:
        pytest.fail("the native library is committed with the repo")
    monkeypatch.setattr(TNV, "library", lambda: None)
    with pytest.raises(RuntimeError, match="gbd1"):
        gt.deserialize(blob, device="cpu")


def test_not_a_blob():
    with pytest.raises(gt.errors.InvalidObject):
        TS.serialized_get(b"XXXX\0\0\0\0{}")


def test_pack_unpack(rng):
    _, At = typed_pair(rng, (20, 15), 0.3, np.float64, which=80)
    ref = At.dup()
    meta, arrays = TS.unpack(At)
    assert At.nvals == 0
    B = TS.pack(meta["shape"], meta["dtype"], meta["format"],
                meta["orient"], iso=meta["iso"], **arrays)
    assert B.isequal(ref)
    with pytest.raises(gt.errors.InvalidObject):
        TS.pack((2, 2), "GrB_FP64", "sparse", "row",
                indptr=arrays["indptr"][:3], indices=arrays["indices"],
                values=arrays["values"])


# ---- Matrix Market ----------------------------------------------------------

MTX = {
    "general": ("%%MatrixMarket matrix coordinate real general\n"
                "% a comment\n4 5 6\n1 1 1.5\n2 3 -2.25\n4 5 3e2\n"
                "3 1 7\n1 5 0.125\n2 3 1.0\n"),
    "symmetric": ("%%MatrixMarket matrix coordinate real symmetric\n"
                  "4 4 5\n1 1 2.0\n2 1 -1.5\n3 2 4.0\n4 4 8.0\n4 1 0.5\n"),
    "skew": ("%%MatrixMarket matrix coordinate real skew-symmetric\n"
             "3 3 2\n2 1 1.5\n3 2 -4.0\n"),
    "integer": ("%%MatrixMarket matrix coordinate integer general\n"
                "3 4 3\n1 2 5\n3 4 -7\n2 2 12\n"),
    "pattern": ("%%MatrixMarket matrix coordinate pattern symmetric\n"
                "5 5 4\n2 1\n3 3\n5 2\n4 1\n"),
}


@pytest.mark.parametrize("scipy_reader", [False, True])
@pytest.mark.parametrize("kind", list(MTX))
def test_from_mtx(tmp_path, monkeypatch, kind, scipy_reader):
    path = tmp_path / f"{kind}.mtx"
    path.write_text(MTX[kind])
    Aj = gb.Matrix.from_mtx(path)
    if scipy_reader:
        monkeypatch.setattr(TNV, "library", lambda: None)
    At = gt.Matrix.from_mtx(path)
    assert At.dtype == gt.types.FP64
    assert_same(Aj, At)
    import scipy.io as sio
    want = sio.mmread(str(path)).toarray()
    np.testing.assert_array_equal(At.to_scipy().toarray(), want)
