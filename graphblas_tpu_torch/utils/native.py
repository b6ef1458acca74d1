"""The port's own ctypes loader for the repository's native host library
(``native/libgbtpu_native.so``, built from ``native/gbtpu_native.cpp``),
for the one entry the port uses: the SELL SpGEMM layout sweep.

The JAX package's loader (``graphblas_tpu.utils.native``) imports that
package, which imports JAX, so the port keeps this copy.  The library is
loaded when its file exists; ``spgemm_layout_plain`` is the pure-Python
sweep with the same semantics (it costs seconds at m = 2^20 rows).
``sweeps`` counts which sweep ran.
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
