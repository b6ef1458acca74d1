"""Serialize / deserialize and O(1) pack / unpack (counterpart of
``graphblas_tpu.ops.serialize``; reference: Source/GB_serialize.c,
GxB_Serialized_get, GxB_Matrix_pack/unpack_*).

The blob is the JAX package's, byte for byte, so a blob written by
either package loads in the other: ``MAGIC`` b"GBTP", a little-endian
uint32 header length, a JSON header (version, class, shape, type name,
format, orientation, iso, nvals, codec, and each array's numpy dtype
name, shape and encoded size), then the encoded arrays in the order
indptr, h, indices, values, bitmap.  Codecs: ``none``, ``zlib``, ``zstd``
(only where the ``zstandard`` module imports; else the default falls
back to zlib) and ``gbz``: a 1-D integer array is delta coded
(``utils.native.delta_encode``: varint ``gbd1`` with the native library,
plain ``raw0`` without), any other array byte-shuffled, and zlib
finishes both.  Arrays go through the host: UINT64 as its bytes, BF16
as its raw 2-byte values through an int16 view (numpy has no bfloat16
here), named "bfloat16" in the header as the JAX package names them.  A
struct type is named in the header; a reader that does not know the name
makes the type from the values array (the JAX package's reader cannot:
``graphblas_tpu/ops/serialize.py:150`` looks the name up among the
built-in types).
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np
import torch

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..core.matrix import Matrix, Scalar, Vector

MAGIC = b"GBTP"
VERSION = 1
ARRAYS = ("indptr", "h", "indices", "values", "bitmap")

_CODECS = {
    "none": (lambda b, level: b, lambda b: b),
    "zlib": (lambda b, level: zlib.compress(b, min(level, 9)),
             zlib.decompress),
}

try:  # zstd levels 1-19 (reference: GxB_COMPRESSION_ZSTD); not in every
    #   installation
    import zstandard as _zstd

    _CODECS["zstd"] = (
        lambda b, level: _zstd.ZstdCompressor(
            level=max(1, min(level, 19))).compress(b),
        lambda b: _zstd.ZstdDecompressor().decompress(b))
except ImportError:  # pragma: no cover
    pass


def register_codec(name, compress, decompress):
    """Plug in an external codec: ``compress(bytes, level) -> bytes`` and
    ``decompress(bytes) -> bytes``, named in the blob's header."""
    _CODECS[name] = (compress, decompress)


def _gbz_compress_array(npa: np.ndarray, level: int,
                        shuffle: bool = False) -> bytes:
    from ..utils import native as NV
    if np.issubdtype(npa.dtype, np.integer) and npa.ndim == 1 \
            and not shuffle:
        body = NV.delta_encode(npa.astype(np.int64))
        return b"D" + zlib.compress(body, min(level + 2, 9))
    return b"S" + zlib.compress(NV.byteshuffle(npa), min(level + 2, 9))


def _gbz_decompress_array(blob: bytes, dtype, shape) -> np.ndarray:
    from ..utils import native as NV
    kind, body = blob[:1], zlib.decompress(blob[1:])
    n = int(np.prod(shape)) if shape else 1
    if kind == b"D":
        return NV.delta_decode(body, n).astype(dtype).reshape(shape)
    return NV.byteunshuffle(body, dtype, n).reshape(shape)


BF16_NAME = "bfloat16"


def _host(t: torch.Tensor):
    """(numpy array, dtype name in the header) of a tensor's bytes."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), BF16_NAME
    npa = t.numpy()
    return npa, str(npa.dtype)


def serialize(A: Matrix, compression=None, level=None, desc=None) -> bytes:
    """Matrix -> blob (GxB_Matrix_serialize).  ``compression``/``level``
    win, then the descriptor's fields, then zstd (zlib where the module
    is absent), level 1."""
    A.wait()
    if compression is None:
        compression = getattr(desc, "compression", None) or (
            "zstd" if "zstd" in _CODECS else "zlib")
    if level is None:
        level = getattr(desc, "compression_level", None) or 1
    if compression == "zstd" and "zstd" not in _CODECS:
        compression = "zlib"
    if compression != "gbz" and compression not in _CODECS:
        raise E.InvalidValue(f"unknown codec {compression!r}")
    arrays = {}
    for name in ARRAYS:
        arr = getattr(A, name)
        if arr is not None:
            npa, dname = _host(arr)
            enc = (_gbz_compress_array(npa, level, dname == BF16_NAME)
                   if compression == "gbz"
                   else _CODECS[compression][0](npa.tobytes(), level))
            arrays[name] = (dname, list(npa.shape), enc)
    header = {
        "version": VERSION,
        "class": type(A).__name__,
        "shape": list(A.shape),
        "dtype": A.dtype.name,
        "format": A.fmt,
        "orient": A.orient,
        "iso": A.iso,
        "nvals": A.nvals,
        "compression": compression,
        "arrays": {k: {"dtype": v[0], "shape": v[1], "nbytes": len(v[2])}
                   for k, v in arrays.items()},
    }
    hb = json.dumps(header).encode()
    blob = b"".join([MAGIC, struct.pack("<I", len(hb)), hb]
                    + [arrays[k][2] for k in header["arrays"]])
    CFG.burble("serialize: %d bytes (%s)", len(blob), compression)
    return blob


def serialized_get(blob: bytes) -> dict:
    """The blob's header, without deserializing (GxB_Serialized_get)."""
    if blob[:4] != MAGIC:
        raise E.InvalidObject("not a graphblas_tpu blob")
    hlen = struct.unpack("<I", blob[4:8])[0]
    return json.loads(blob[8:8 + hlen].decode())


def deserialize(blob: bytes, device=None) -> Matrix:
    """Blob -> Matrix / Vector / Scalar (GxB_Matrix_deserialize) on
    ``device`` (default ``config.default_device()``)."""
    device = CFG.default_device(device)
    header = serialized_get(blob)
    comp = header["compression"]
    if comp != "gbz" and comp not in _CODECS:
        raise E.InvalidValue(f"blob codec {comp!r} is not available")
    pos = 8 + struct.unpack("<I", blob[4:8])[0]
    arrays = {}
    for name, meta in header["arrays"].items():
        raw = blob[pos:pos + meta["nbytes"]]
        pos += meta["nbytes"]
        bf16 = meta["dtype"] == BF16_NAME
        dtype = np.int16 if bf16 else meta["dtype"]
        if comp == "gbz":
            npa = _gbz_decompress_array(raw, dtype, meta["shape"])
        else:
            npa = np.frombuffer(_CODECS[comp][1](raw),
                                dtype).reshape(meta["shape"])
        t = torch.from_numpy(npa.copy())
        arrays[name] = (t.view(torch.bfloat16) if bf16 else t).to(device)
    klass = {"Matrix": Matrix, "Vector": Vector, "Scalar": Scalar}[
        header["class"]]
    return pack(header["shape"], _blob_type(header), header["format"],
                header["orient"], iso=header["iso"], klass=klass,
                trusted=True, device=device, **arrays)


def _blob_type(header) -> T.Type:
    """The blob's type: a built-in or known struct type by name, else a
    struct type made from the values array (its dtype, and its dims past
    the entry axes: one for iso and sparse values, two for dense)."""
    try:
        return T.lookup(header["dtype"])
    except KeyError:
        meta = header["arrays"]["values"]
        lead = 1 if header["iso"] or header["format"] in ("sparse", "hyper") \
            else 2
        return T.struct_type(header["dtype"], meta["dtype"],
                             meta["shape"][lead:])


# ---------------------------------------------------------------------------
# O(1) pack / unpack (move semantics)
# ---------------------------------------------------------------------------

def pack(shape, dtype, fmt, orient, *, indptr=None, h=None, indices=None,
         values=None, bitmap=None, iso=False, klass=Matrix, trusted=False,
         device=None) -> Matrix:
    """Adopt the given tensors as a Matrix in O(1) (GxB_Matrix_pack_*).
    With ``trusted=False`` the structure is checked (the import 'secure'
    mode)."""
    out = object.__new__(klass)
    Matrix.__init__(out, (int(shape[0]), int(shape[1])), T.lookup(dtype),
                    fmt, orient, iso=bool(iso), indptr=indptr, h=h,
                    indices=indices, values=values, bitmap=bitmap,
                    device=device)
    if not trusted:
        out.check()
    return out


def unpack(A: Matrix):
    """Surrender a matrix's tensors in O(1) (GxB_Matrix_unpack_*):
    (metadata dict, tensors dict); A is cleared."""
    A.wait()
    meta = {"shape": A.shape, "dtype": A.dtype, "format": A.fmt,
            "orient": A.orient, "iso": A.iso}
    arrays = {k: getattr(A, k) for k in ARRAYS}
    A.clear()
    return meta, arrays
