"""The port's own ctypes loader for the repository's native host library
(``native/libgbtpu_native.so``, built from ``native/gbtpu_native.cpp``),
for the entries the port uses: the SELL SpGEMM layout sweep, the
Matrix Market reader (``read_mtx``) and the gbz serialize codec's
delta coder and byte shuffle.

The JAX package's loader (``graphblas_tpu.utils.native``) imports that
package, which imports JAX, so the port keeps this copy.  The library is
loaded when its file exists; without it each entry has a numpy or scipy
version: ``spgemm_layout_plain`` is the pure-Python sweep with the same
semantics (it costs seconds at m = 2^20 rows), ``delta_encode`` writes
the plain-delta ``raw0`` form instead of the varint ``gbd1`` one (both
decode anywhere but ``gbd1``, which needs the library), and
``read_mtx`` uses scipy's ``mmread``.  ``sweeps`` counts which sweep
ran.  The blobs are the JAX package's byte for byte.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

LIB_PATH = Path(__file__).resolve().parents[2] / "native" / \
    "libgbtpu_native.so"

sweeps = {"native": 0, "python": 0}
_lib = None


def library():
    """The loaded native library, or None when its file is absent."""
    global _lib
    if _lib is None and LIB_PATH.exists():
        lib = ctypes.CDLL(str(LIB_PATH))
        P, I = ctypes.c_void_p, ctypes.c_int64
        lib.gbtpu_spgemm_layout.argtypes = [P, P, P, I, I, I, I, I, P, P, P,
                                            P, P, P, I]
        lib.gbtpu_spgemm_layout.restype = I
        lib.gbtpu_delta_encode_i64.argtypes = [P, I, P]
        lib.gbtpu_delta_encode_i64.restype = I
        lib.gbtpu_delta_decode_i64.argtypes = [P, I, P, I]
        lib.gbtpu_delta_decode_i64.restype = I
        lib.gbtpu_byteshuffle.argtypes = [P, I, I, P]
        lib.gbtpu_byteunshuffle.argtypes = [P, I, I, P]
        lib.gbtpu_mtx_header.argtypes = [ctypes.c_char_p, P, P, P, P, P]
        lib.gbtpu_mtx_header.restype = ctypes.c_int
        lib.gbtpu_mtx_read.argtypes = [ctypes.c_char_p, P, P, P, I,
                                       ctypes.c_int]
        lib.gbtpu_mtx_read.restype = ctypes.c_int
        _lib = lib
    return _lib


def spgemm_layout_plain(row_nseg, row_nent, row_tok, tile_segs: int,
                        blk_segs: int, blk_ents: int, blk_rows: int):
    """The layout sweep in Python (see ``spgemm_layout``)."""
    m = row_nseg.shape[0]
    starts = np.empty(m + 1, np.int64)
    rank = np.zeros(m, np.int32)
    br0, be0, bt0, bs0 = [], [], [], []
    cursor = ecur = tcur = 0
    tile0 = 0
    rk = 0
    for r in range(m):
        s = int(row_nseg[r])
        ne = int(row_nent[r])
        nt = int(row_tok[r]) if row_tok is not None else 0
        if s > 0:
            if cursor - tile0 + s > tile_segs:
                tile0 += tile_segs
                cursor = tile0
                rk = 0
            need = (not br0 or (cursor + s) - bs0[-1] > blk_segs
                    or (ecur + ne) - be0[-1] > blk_ents
                    or (r + 1) - br0[-1] > blk_rows
                    or (tcur + nt) - bt0[-1] > blk_rows)
            if need:
                cursor = ((cursor + blk_segs - 1) // blk_segs) * blk_segs
                if br0 and cursor == bs0[-1]:
                    cursor += blk_segs
                if not br0:
                    cursor = 0
                tile0 = cursor
                rk = 0
                br0.append(r)
                be0.append(ecur)
                bt0.append(tcur)
                bs0.append(cursor)
            starts[r] = cursor
            rank[r] = rk
            cursor += s
            rk += 1
        else:
            starts[r] = cursor
        ecur += ne
        tcur += nt
    starts[m] = ((cursor + blk_segs - 1) // blk_segs) * blk_segs
    if not br0:
        br0, be0, bt0, bs0 = [0], [0], [0], [0]
        if starts[m] == 0:
            starts[m] = blk_segs
    return (starts, rank, np.asarray(br0, np.int64),
            np.asarray(be0, np.int64), np.asarray(bt0, np.int64),
            np.asarray(bs0, np.int64))


def spgemm_layout(row_nseg, row_nent, row_tok, tile_segs: int,
                  blk_segs: int, blk_ents: int, blk_rows: int):
    """SELL SpGEMM layout sweep: padded per-row segment starts (a row
    never straddles a sort tile of ``tile_segs`` segments), per-row tile
    ranks, and block boundaries under segment / entry / row / token
    budgets.  ``row_tok`` may be None.

    Returns (row_startseg (m+1,) int64, tile_rank (m,) int32, blk_r0,
    blk_e0, blk_t0, blk_seg0 — each (nblocks,) int64).  Runs the native
    sweep when the library is present, else the Python one."""
    rn = np.ascontiguousarray(row_nseg, np.int64)
    re_ = np.ascontiguousarray(row_nent, np.int64)
    rt = None if row_tok is None else np.ascontiguousarray(row_tok,
                                                           np.uint8)
    lib = library()
    if lib is None:
        sweeps["python"] += 1
        return spgemm_layout_plain(rn, re_, rt, tile_segs, blk_segs,
                                   blk_ents, blk_rows)
    m = rn.shape[0]
    starts = np.empty(m + 1, np.int64)
    rank = np.empty(m, np.int32)
    maxb = max(16, 2 * (int(rn.sum()) // max(blk_segs, 1) + 2)
               + m // max(blk_rows, 1) + 4)
    blk = [np.empty(maxb, np.int64) for _ in range(4)]
    nb = lib.gbtpu_spgemm_layout(
        rn.ctypes.data, re_.ctypes.data, None if rt is None else
        rt.ctypes.data, m, tile_segs, blk_segs, blk_ents, blk_rows,
        starts.ctypes.data, rank.ctypes.data,
        *(b.ctypes.data for b in blk), maxb)
    if nb <= 0:
        raise RuntimeError(f"gbtpu_spgemm_layout: {maxb} blocks exceeded")
    sweeps["native"] += 1
    return (starts, rank, *(b[:nb].copy() for b in blk))


# ---------------------------------------------------------------------------
# the gbz serialize codec's array transforms and the Matrix Market reader
# ---------------------------------------------------------------------------

def delta_encode(arr: np.ndarray) -> bytes:
    """int64 deltas: ``gbd1`` + zig-zag varints with the library, ``raw0``
    + the plain int64 deltas without it."""
    a = np.ascontiguousarray(arr, np.int64)
    lib = library()
    if lib is None:
        return b"raw0" + np.diff(a, prepend=np.int64(0)).tobytes()
    out = np.empty(10 * len(a) + 16, np.uint8)
    n = lib.gbtpu_delta_encode_i64(a.ctypes.data, len(a), out.ctypes.data)
    return b"gbd1" + bytes(out[:n])


def delta_decode(blob: bytes, n: int) -> np.ndarray:
    tag, body = blob[:4], blob[4:]
    if tag == b"raw0":
        return np.cumsum(np.frombuffer(body, np.int64, n)).astype(np.int64)
    lib = library()
    if lib is None:
        raise RuntimeError("a gbd1 blob needs the native library")
    out = np.empty(n, np.int64)
    buf = np.frombuffer(body, np.uint8)
    lib.gbtpu_delta_decode_i64(buf.ctypes.data, len(buf), out.ctypes.data,
                               n)
    return out


def byteshuffle(arr: np.ndarray) -> bytes:
    """The bytes of ``arr`` grouped by byte position (byte 0 of every
    element, then byte 1, ...)."""
    a = np.ascontiguousarray(arr)
    raw = a.view(np.uint8).reshape(-1)
    item, n = a.dtype.itemsize, a.size
    lib = library()
    if lib is None:
        return raw.reshape(n, item).T.copy().tobytes()
    out = np.empty(raw.size, np.uint8)
    lib.gbtpu_byteshuffle(raw.ctypes.data, n, item, out.ctypes.data)
    return out.tobytes()


def byteunshuffle(blob: bytes, dtype, n: int) -> np.ndarray:
    dt = np.dtype(dtype)
    raw = np.frombuffer(blob, np.uint8)
    lib = library()
    if lib is None:
        return np.ascontiguousarray(
            raw.reshape(dt.itemsize, n).T).view(dt).reshape(n).copy()
    raw = np.ascontiguousarray(raw)
    out = np.empty(raw.size, np.uint8)
    lib.gbtpu_byteunshuffle(raw.ctypes.data, n, dt.itemsize,
                            out.ctypes.data)
    return out.view(dt)[:n].copy()


def read_mtx(path: str):
    """(rows int32, cols int32, vals float64, shape) of a Matrix Market
    file; symmetric and skew-symmetric files are expanded, pattern files
    read as ones.  The native parser when the library is present, else
    scipy's ``mmread``."""
    lib = library()
    if lib is None:
        import scipy.io as sio
        m = sio.mmread(path).tocoo()
        return (m.row.astype(np.int32), m.col.astype(np.int32),
                m.data.astype(np.float64), m.shape)
    hdr = [np.zeros(1, np.int64) for _ in range(3)]
    sym, pat = np.zeros(1, np.int32), np.zeros(1, np.int32)
    rc = lib.gbtpu_mtx_header(str(path).encode(),
                              *(h.ctypes.data for h in hdr),
                              sym.ctypes.data, pat.ctypes.data)
    if rc != 0:
        raise IOError(f"mtx header parse failed ({rc}): {path}")
    nr, nc, n = (int(h[0]) for h in hdr)
    rows = np.empty(n, np.int32)
    cols = np.empty(n, np.int32)
    vals = np.empty(n, np.float64)
    rc = lib.gbtpu_mtx_read(str(path).encode(), rows.ctypes.data,
                            cols.ctypes.data, vals.ctypes.data, n,
                            int(pat[0]))
    if rc != 0:
        raise IOError(f"mtx body parse failed ({rc}): {path}")
    if pat[0]:
        vals[:] = 1.0
    if sym[0]:
        off = rows != cols
        sign = -1.0 if sym[0] == 2 else 1.0
        rows, cols = (np.concatenate([rows, cols[off]]),
                      np.concatenate([cols, rows[off]]))
        vals = np.concatenate([vals, sign * vals[off]])
    return rows, cols, vals, (nr, nc)
