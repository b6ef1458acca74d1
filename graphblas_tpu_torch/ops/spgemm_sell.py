"""SELL SpGEMM, the default sparse x sparse tier (counterpart of
``graphblas_tpu.ops.spgemm_sell``; reference: the saxpy3 Gustavson/hash
tasks, Source/GB_AxB_saxpy3.c:272-420).

  * B is packed once per call into a SELL-8 table: each CSR row split
    into 8-wide segments of (column, value) planes, so expanding a
    product run is one row gather per segment.  Mask rows are appended
    to the table as token segments (the dot3 analog).
  * No per-row capacity classes: rows pad to 8-slot multiples and never
    straddle one sort tile of TILE slots.  The sort key packs (row rank
    within the tile << JB) | j, so one sort-reduce kernel at C = TILE
    groups duplicates for mixed row lengths; with n >= 2^23 - 1 the key
    is two planes (rank, j) and the wide kernel sorts them
    lexicographically.
  * A host layout sweep (``utils/native.py``) cuts the padded slot space
    into blocks; pass 1 walks them in order (a Python loop, where the JAX
    package runs a ``lax.scan``), expands each block's products with
    scatters and cummax fills, and runs the sort-reduce kernel on it:

        unmasked                          K5 sort_reduce_rows
        masked, materialised              K6 sort_reduce_rows_tok
        fused masked PAIR count (n<2^22)  K7 sort_reduce_pair1
        wide keys (n >= 2^23 - 1)         K8 sort_reduce_rows_wide

    Each block owns its window of the output planes and writes only that
    window, in order; the fused reduce counts only the slots a block owns.
  * Per-row output counts come from a per-tile backward cummin of the
    run-end keys and a binary search per row (``_counts``); placement is
    one scatter whose destinations are cumsum arithmetic (``_pass2``).

Rows whose padded slots exceed TILE fall back to the classic ESC path
(ops/mxm.py), merged by row id into the same output.  Host syncs: one
packed copy of the per-row metadata (``host_meta``) and the output nnz.
The JAX package's shape bucketing and its per-phase jits exist for XLA
compiles and are not carried over.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config as CFG
from ..core import types as T
from ..core.matrix import HYPER, INDEX, ROW, SPARSE, Matrix
from ..core.types import cast
from ..kernels import segment as K
from ..kernels import sortreduce as SRD
from ..utils import native as NAT
from ..utils.tensor_cache import TensorCache

SEGW = 8                   # SELL segment width (slots per gather row)
TILE = 2048                # sort tile = kernel capacity C
JB = 23                    # bits for j in the packed key; rank gets 31-JB
NMAX = (1 << JB) - 1       # n at or above this needs the wide key planes
LOW32 = (1 << 32) - 1
WSENT = 1 << 62            # wide-mode packed-key sentinel (sorts last)
SENT = SRD.SENTINEL
# SELL declines a product (the caller then takes the fast tier) when B's
# table holds MAX_TABLE_SEGS segments or more, or when the padded slot
# domain reaches MAX_SLOTS or the table plus the mask MAX_SEGS segments:
# int32 slot and payload bounds, as in the JAX engine.  Unlike the JAX
# engine, the slot domain counts the fallback rows' padded slots too:
# SELL holds all of their classic outputs at once (RMAT-18's A*A: 2.9e9
# products in fallback rows, beyond the card's memory), while the fast
# tier cuts its fallback rows into blocks.
MAX_TABLE_SEGS = 1 << 27
MAX_SLOTS = 1 << 31
MAX_SEGS = 1 << 30

# value types carried by the kernels: (kernel value dtype, bool carried)
KDT = {
    np.dtype(np.bool_): (torch.int32, True),
    np.dtype(np.int8): (torch.int32, False),
    np.dtype(np.uint8): (torch.int32, False),
    np.dtype(np.int16): (torch.int32, False),
    np.dtype(np.int32): (torch.int32, False),
    np.dtype(np.float32): (torch.float32, False),
}


def _kdt_for(zt):
    """(kernel value dtype, logical) for a SELL-eligible type: PAIR into a
    64-bit integer accumulates in int32 (per-key sums are bounded by
    TILE) and widens on output."""
    return KDT.get(zt.np_dtype, (torch.int32, False))


NARROW = (np.dtype(np.int8), np.dtype(np.uint8), np.dtype(np.int16))


def _as_products(x, zt, kdt):
    """Products in the kernel's value type, wrapped to ``zt`` on the way:
    a narrow integer product that overflows ``zt`` then reduces (MIN,
    MAX) as the classic path's wrapped value, not as its int32 one."""
    if zt.np_dtype in NARROW:
        x = cast(x, zt)
    return cast(x, T.lookup(kdt))


def ineligible(sr, zt, n: int):
    """Why SELL cannot run this product, or None when it can."""
    if not CFG.GLOBAL.kernels_enabled:
        return "kernels disabled"
    if sr.mult.positional:
        return "positional multiply"
    if n >= (1 << 31) - 1:
        return "n beyond int32 columns"
    if zt.np_dtype not in KDT and not (zt.np_dtype == np.int64
                                       and sr.mult.name == "GrB_ONEB"):
        return f"type {zt.name}"
    _, logical = _kdt_for(zt)
    if SRD.kernel_op(sr.add, logical) is None:
        return f"no sort-reduce kernel for {sr.add.name}"
    return None


def _mode(sr):
    name = sr.mult.name
    return ("pair" if name == "GrB_ONEB" else "first" if name == "GrB_FIRST"
            else "second" if name == "GrB_SECOND" else "general")


def _pow2(x):
    p = 1
    while p < x:
        p *= 2
    return p


def _cat0(x):
    """[0, cumsum(x)...] in int64."""
    out = torch.zeros(x.numel() + 1, dtype=torch.int64, device=x.device)
    torch.cumsum(x, 0, out=out[1:])
    return out


def _cummax(x, chunk: int = 1024):
    """Inclusive running max of a 1-D tensor.  torch.cummax scans a 1-D
    CUDA tensor in one thread block (~1.1 s for the 3.4e8 slots of
    bench.py's A*A on an H100), so this scans rows of ``chunk`` in
    parallel, then carries each row's running max into the next rows."""
    n = x.numel()
    if n <= chunk:
        return torch.cummax(x, 0).values
    pad = (-n) % chunk
    if pad:
        x = torch.cat([x, x[-1:].expand(pad)])
    y = torch.cummax(x.reshape(-1, chunk), 1).values
    carry = _cummax(y[:, -1].contiguous(), chunk)
    torch.maximum(y[1:], carry[:-1, None], out=y[1:])
    return y.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# prep: per-row metadata (phase A), SELL table (B), layout, entries (C)
# ---------------------------------------------------------------------------

_prep_cache = TensorCache(4)


def _prep_operands(Ar, Br, mask, desc, mode, zt, kdt, m, n):
    """(tensors, flags) that ``_prep`` is pure in: the patterns of A, B
    and the mask, and the values the mode reads (A's under FIRST or a
    general multiply, B's under SECOND or a general multiply, the mask's
    unless it is structural)."""
    ts = [Ar.indptr, Ar.indices, Br.indptr, Br.indices]
    if mode in ("first", "general"):
        ts.append(Ar.values)
    if mode in ("second", "general"):
        ts.append(Br.values)
    flags = [mode, zt.name, kdt, int(m), int(n)]
    if mask is not None:
        ts += [t for t in (mask.indptr, mask.h, mask.indices) if t is not None]
        if not desc.mask_structure and mask.values is not None:
            ts.append(mask.values)
        flags += [mask.fmt, mask.orient, tuple(mask.shape),
                  bool(desc.mask_structure), bool(desc.mask_complement)]
    return ts, flags


def _prep(Ar, Br, ip_h, sr, zt, m, n, mask, desc, mode, kdt):
    """Everything before pass 1; pure in (A, B, mask, semiring mode), so
    cached while the operands live (utils/tensor_cache.py).  None when the
    slot domain exceeds int32."""
    ts, flags = _prep_operands(Ar, Br, mask, desc, mode, zt, kdt, m, n)
    pv = _prep_cache.get(ts, flags)
    if pv is not None:
        return pv
    dev = Ar.device
    # ---- phase A: segment bases, per-row loads, mask degrees ------------
    bip = Br.indptr.long()
    aip = Ar.indptr.long()
    aix = Ar.indices.long()
    nsegB = (torch.diff(bip) + (SEGW - 1)) // SEGW
    segbaseB = _cat0(nsegB)
    nseg_e = nsegB[aix]
    cumseg = _cat0(nseg_e)
    row_segbase = cumseg[aip]
    row_nseg = torch.diff(row_segbase)
    masked = mask is not None and mask.fmt in (SPARSE, HYPER)
    Mr = mask.to_format(SPARSE, ROW) if masked else None
    nnzM = int(Mr.indices.shape[0]) if masked else 0
    valued = masked and not desc.mask_structure and nnzM > 0
    meta = [segbaseB[-1:], row_nseg]
    if masked:
        mip = Mr.indptr.long()
        if valued:
            mkeep = Mr._vals_expanded() != 0
            mkcum = _cat0(mkeep.long())
            mdeg = mkcum[mip[1:]] - mkcum[mip[:-1]]
        else:
            mdeg = torch.diff(mip)
        meta.append(mdeg)
    meta = torch.cat(meta).cpu().numpy()             # ONE packed D2H
    nsegB_tot = int(meta[0])
    row_nseg_h = meta[1:1 + m]
    if nsegB_tot >= MAX_TABLE_SEGS:
        CFG.burble("spgemm-sell: B table too large (%d segments)",
                   nsegB_tot)
        return None
    nsegM_tot = 0
    if masked:
        msegs_h = (meta[1 + m:1 + 2 * m] + (SEGW - 1)) // SEGW
        msegbase_h = np.zeros(m + 1, np.int64)
        np.cumsum(msegs_h, out=msegbase_h[1:])
        nsegM_tot = int(msegbase_h[-1])
    # ---- phase B: the SELL table (column plane, value plane) ------------
    tblN = nsegB_tot + nsegM_tot + 1
    nnzB = int(Br.indices.shape[0])
    rowsB = K.expand_rowids(Br.indptr, nnzB, Br.nrows).long()
    destB = segbaseB[rowsB] * SEGW + torch.arange(nnzB, device=dev) \
        - bip[rowsB]
    tblj = torch.full((tblN * SEGW,), SENT, dtype=torch.int32, device=dev)
    tblj[destB] = Br.indices.to(torch.int32)
    tblv = None
    if mode in ("second", "general"):
        tblv = torch.zeros(tblN * SEGW, dtype=kdt, device=dev)
        bv = Br._vals_expanded()
        tblv[destB] = _as_products(bv, zt, kdt) if mode == "second" \
            else cast(bv, T.lookup(kdt))
        tblv = tblv.reshape(tblN, SEGW)
    if masked and nnzM:
        mrows = K.expand_rowids(Mr.indptr, nnzM, m).long()
        if valued:
            within = mkcum[1:] - 1 - mkcum[mip[mrows]]
        else:
            within = torch.arange(nnzM, device=dev) - mip[mrows]
        msegbase = torch.from_numpy(msegbase_h).to(dev)
        destM = (nsegB_tot + msegbase[mrows]) * SEGW + within
        mix = Mr.indices.to(torch.int32)
        if valued:
            destM, mix = destM[mkeep], mix[mkeep]
        tblj[destM] = mix
    tblj = tblj.reshape(tblN, SEGW)
    # ---- host layout sweep -----------------------------------------------
    if masked:
        tok_h = ((row_nseg_h > 0) & (msegs_h > 0)).astype(np.uint8)
        row_load_h = row_nseg_h + np.where(tok_h > 0, msegs_h, 0)
    else:
        tok_h = None
        row_load_h = row_nseg_h.copy()
    fb_rows = np.flatnonzero(row_load_h * SEGW > TILE)
    fb_slots = int(row_load_h[fb_rows].sum()) * SEGW
    if fb_rows.size:
        # fallback rows run the classic path, which applies the mask
        # itself; their tokens would land in a neighbour row's segments
        row_load_h[fb_rows] = 0
        if masked:
            tok_h[fb_rows] = 0
    total_segs = int(row_load_h.sum())
    S8 = max(1 << 13, min(1 << 21, _pow2(max(total_segs, 1))))
    E_BLK = S8
    R_BLK = max(min(S8, 1 << 19), 1 << 10)
    starts_h, rank_h, br0, be0, bt0, bs0 = NAT.spgemm_layout(
        row_load_h, np.diff(ip_h), tok_h, TILE // SEGW, S8, E_BLK, R_BLK)
    D_pad = int(starts_h[m]) * SEGW
    if D_pad + fb_slots >= MAX_SLOTS or nsegB_tot + nsegM_tot >= MAX_SEGS:
        CFG.burble("spgemm-sell: slot domain beyond int32 (%d slots with "
                   "the fallback's %d)", D_pad + fb_slots, fb_slots)
        return None
    # ---- phase C: per-entry run arrays ------------------------------------
    nnzA = int(Ar.indices.shape[0])
    a_rows = K.expand_rowids(Ar.indptr, nnzA, m).long()
    starts_d = torch.from_numpy(starts_h).to(dev)
    fbm = torch.zeros(m, dtype=torch.bool, device=dev)
    fbm[torch.from_numpy(fb_rows).to(dev)] = True
    ent = {"rs": starts_d[a_rows] + cumseg[:-1] - row_segbase[:-1][a_rows],
           "sb": segbaseB[aix],
           "ns": torch.where(fbm[a_rows], 0, nseg_e)}
    if mode in ("first", "general"):
        av = Ar._vals_expanded()
        ent["av"] = _as_products(av, zt, kdt) if mode == "first" \
            else cast(av, T.lookup(kdt))
    if masked:
        trow = np.flatnonzero(tok_h)
        tok = {"rs": starts_h[trow] + row_nseg_h[trow],
               "sb": nsegB_tot + msegbase_h[trow], "ns": msegs_h[trow]}
        tok = {k: torch.from_numpy(np.ascontiguousarray(v, np.int64))
               .to(dev) for k, v in tok.items()}
    else:
        tok = None
    live_h = row_load_h > 0
    pv = {"tblj": tblj, "tblv": tblv, "ent": ent, "tok": tok,
          "row_start": starts_d[:m], "rank": torch.from_numpy(
              rank_h.astype(np.int64)).to(dev),
          "live": torch.from_numpy(live_h).to(dev), "live_h": live_h,
          "blocks": list(zip(br0.tolist(), be0.tolist(), bt0.tolist(),
                             bs0.tolist(),
                             np.diff(bs0, append=D_pad // SEGW).tolist())),
          "S8": S8, "E_BLK": E_BLK, "R_BLK": R_BLK, "D_pad": D_pad,
          "fb_rows": fb_rows, "starts_h": starts_h, "masked": masked,
          "nsegB_tot": nsegB_tot, "zt": zt}
    CFG.burble("spgemm-sell: %d blocks, %d padded slots, %d fallback rows",
               len(pv["blocks"]), D_pad, fb_rows.size)
    return _prep_cache.put(ts, flags, pv)


# ---------------------------------------------------------------------------
# pass 1: blocks in order -> sorted/deduped run-end planes (or a sum)
# ---------------------------------------------------------------------------

def _fill_from_starts(S8, pos, vals, dev):
    """Per slot of the window: the value at the latest start <= slot
    (starts ``pos`` are unique) and whether a start precedes it."""
    mark = torch.zeros(S8, dtype=torch.int64, device=dev)
    mark[pos] = pos + 1
    last = _cummax(mark) - 1
    lastc = last.clamp(min=0)
    out = []
    for v in vals:
        p = torch.zeros(S8, dtype=v.dtype, device=dev)
        p[pos] = v
        out.append(p[lastc])
    return last >= 0, out


def _block_products(pv, blk, mode, mult, kdt, n):
    """Expansion of one block: per window slot (S8 segments x SEGW) the
    column j, the product value, the row's tile rank, validity, and
    whether the slot is a mask token."""
    S8, E_BLK, R_BLK = pv["S8"], pv["E_BLK"], pv["R_BLK"]
    r0, e0, t0, seg0, _ = blk
    ent, tok = pv["ent"], pv["tok"]
    dev = pv["tblj"].device
    rs = ent["rs"][e0:e0 + E_BLK] - seg0
    sb = ent["sb"][e0:e0 + E_BLK]
    ns = ent["ns"][e0:e0 + E_BLK]
    av = ent["av"][e0:e0 + E_BLK] if "av" in ent else None
    if tok is not None:
        tr = tok["rs"][t0:t0 + R_BLK] - seg0
        rs = torch.cat([rs, tr])
        sb = torch.cat([sb, tok["sb"][t0:t0 + R_BLK]])
        ns = torch.cat([ns, tok["ns"][t0:t0 + R_BLK]])
        if av is not None:
            av = torch.cat([av, torch.zeros(tr.numel(), dtype=kdt,
                                            device=dev)])
    ok_e = (rs >= 0) & (rs < S8) & (ns > 0)
    pos = rs[ok_e]
    segiota = torch.arange(S8, device=dev)
    fills = [sb[ok_e] - pos, pos + ns[ok_e]]
    if av is not None:
        fills.append(av[ok_e])
    _, filled = _fill_from_starts(S8, pos, fills, dev)
    bseg = filled[0] + segiota
    vseg = segiota < filled[1]
    # row tile rank (key high bits): ranks reset per tile
    rstart = pv["row_start"][r0:r0 + R_BLK] - seg0
    rok = (rstart >= 0) & (rstart < S8) & pv["live"][r0:r0 + R_BLK]
    has_row, (rank,) = _fill_from_starts(
        S8, rstart[rok], [pv["rank"][r0:r0 + R_BLK][rok]], dev)
    rankf = torch.where(has_row, rank, -1)
    tblj, tblv = pv["tblj"], pv["tblv"]
    bsegc = bseg.clamp(0, tblj.shape[0] - 1)
    j = tblj[bsegc]                                   # (S8, SEGW) int32
    valid = vseg[:, None] & (rankf >= 0)[:, None] & (j < n)
    if mode == "pair":
        prod = torch.ones((S8, SEGW), dtype=kdt, device=dev)
    elif mode == "first":
        prod = filled[2][:, None].expand(S8, SEGW)
    elif mode == "second":
        prod = tblv[bsegc]
    else:
        prod = _as_products(mult.fn(filled[2][:, None], tblv[bsegc]),
                            pv["zt"], kdt)
    tokf = (bseg >= pv["nsegB_tot"])[:, None]
    return j, prod, rankf, valid, tokf


def _pass1(pv, sr, mode, kdt, logical, n, comp, reduce_scalar, wide):
    """Runs the blocks in order.  Returns the (OK, OV) run-end planes over
    the padded slot domain, or an int64 device scalar (the sum of every
    kept output) when ``reduce_scalar``."""
    S8, D_pad, masked = pv["S8"], pv["D_pad"], pv["masked"]
    dev = pv["tblj"].device
    D_BLOCK = S8 * SEGW
    monoid = sr.add
    ident_np = monoid.identity_for(np.bool_ if logical else
                                   T.lookup(kdt).np_dtype)
    ident = torch.tensor(int(ident_np) if logical else ident_np.item(),
                         dtype=kdt, device=dev)
    pair1 = (reduce_scalar and masked and mode == "pair" and not wide
             and not logical and n < (1 << 22))
    acc = torch.zeros((), dtype=torch.int64, device=dev)
    if not reduce_scalar:
        OK = torch.full((D_pad,), WSENT if wide else SENT,
                        dtype=torch.int64 if wide else torch.int32,
                        device=dev)
        OV = torch.zeros(D_pad, dtype=kdt, device=dev)
    for blk in pv["blocks"]:
        seg0, own = blk[3], blk[4]
        j, prod, rankf, valid, tokf = _block_products(pv, blk, mode, sr.mult,
                                                      kdt, n)
        rk = rankf[:, None]
        if pair1:
            # 1-plane masked PAIR counter (triangle counting's hot path):
            # the is-product flag inside the key, counts from run lengths
            key = torch.where(valid, (rk << JB) | (j.long() << 1)
                              | (~tokf).long(), SENT).to(torch.int32)
            ov = SRD.sort_reduce_pair1(key.reshape(-1), TILE,
                                       want_token=not comp)
            acc += ov[:own * SEGW].sum(dtype=torch.int64)
            continue
        if masked:
            prod = torch.where(valid & ~tokf, prod, ident)
            tx = torch.where(valid, torch.where(tokf, 1, 2), 0) \
                .to(torch.int32).reshape(-1)
        else:
            prod = torch.where(valid, prod, ident)
            tx = None
        prod = prod.reshape(-1).contiguous()
        if wide:
            kh = torch.where(valid, rk.expand(S8, SEGW), SENT) \
                .to(torch.int32).reshape(-1)
            kl = torch.where(valid, j, SENT).reshape(-1)
            okh, okl, ov = SRD.sort_reduce_rows_wide(
                kh, kl, prod, TILE, monoid, toks=tx, want_token=not comp,
                logical=logical)
            ok = okh if reduce_scalar else torch.where(
                okh == SENT, WSENT,
                (okh.long() << 32) | (okl.long() & LOW32))
        else:
            key = torch.where(valid, (rk << JB) | j.long(), SENT) \
                .to(torch.int32).reshape(-1)
            if masked:
                ok, ov = SRD.sort_reduce_rows_tok(
                    key, prod, tx, TILE, monoid, want_token=not comp,
                    logical=logical)
            else:
                ok, ov = SRD.sort_reduce_rows(key, prod, TILE, monoid,
                                              logical=logical)
        if reduce_scalar:
            # only the slots this block owns count (its window may
            # over-read entries of later rows)
            kept = ok[:own * SEGW] != SENT
            acc += torch.where(kept, ov[:own * SEGW], 0).to(
                torch.int64).sum()
            continue
        w = min(D_BLOCK, D_pad - seg0 * SEGW)
        OK[seg0 * SEGW:seg0 * SEGW + w] = ok[:w]
        OV[seg0 * SEGW:seg0 * SEGW + w] = ov[:w]
    return acc if reduce_scalar else (OK, OV)


# ---------------------------------------------------------------------------
# counts (pass 1.5) and placement (pass 2)
# ---------------------------------------------------------------------------

def _counts(OK, tb, rk, live, jbits: int, sent: int):
    """Per-row output counts and in-tile start positions.  The sorted key
    of every slot is its run's key, found at the run end: a per-tile
    backward cummin rebuilds the sorted keys, and each row's range is a
    binary search for rank << jbits (tb: tile base slot of each row, rk:
    tile rank, live: row has SELL slots)."""
    D = OK.numel()
    kx = OK.reshape(D // TILE, TILE).flip(1).cummin(1).values.flip(1) \
        .reshape(-1)
    Sx = _cat0((OK != sent).long())

    def search(bound):
        lo = torch.zeros_like(tb)
        hi = torch.full_like(tb, TILE)
        for _ in range(TILE.bit_length()):        # search space [0, TILE]
            mid = (lo + hi) // 2
            lt = kx[(tb + mid).clamp(0, D - 1)].long() < bound
            lo = torch.where(lt, mid + 1, lo)
            hi = torch.where(lt, hi, mid)
        return lo                                  # first pos >= bound

    lo_p = search(rk << jbits)
    hi_p = search((rk + 1) << jbits)
    p_lo = tb + lo_p
    cnt = torch.where(live, Sx[tb + hi_p] - Sx[p_lo], 0)
    return cnt, p_lo, Sx


def _pass2(OK, OV, p_lo, live, row_ptr, Sx, nnz: int, jmask: int,
           sent: int):
    """Scatter kept run-end outputs into CSR order: each live row r
    writes indptr[r] - prefix_kept(p_lo[r]) at its in-tile start; the
    values are monotone, so a cummax fill gives every kept slot its
    destination by arithmetic."""
    D = OK.numel()
    kept = OK != sent
    val = row_ptr - Sx[p_lo.clamp(0, D)]
    fill = torch.full((D,), -(1 << 40), dtype=torch.int64, device=OK.device)
    at = live & (p_lo < D)     # a row starting at D has no kept slots
    fill.scatter_reduce_(0, p_lo[at], val[at], "amax")
    fill = _cummax(fill)
    dest = (fill + Sx[:-1])[kept]
    uidx = torch.zeros(nnz, dtype=INDEX, device=OK.device)
    cv = torch.zeros(nnz, dtype=OV.dtype, device=OK.device)
    uidx[dest] = (OK[kept] & jmask).to(INDEX)
    cv[dest] = OV[kept]
    return uidx, cv


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def spgemm_sell(Ar, Br, ip_h, sr, zt, m, n, mask, desc, classic_rows,
                reduce_scalar=False):
    """T = A*B under ``sr`` with the optional in-sort mask filter.

    Ar/Br: CSR matrices; ip_h: host copy of A.indptr; classic_rows(rows)
    -> (counts, uvec, uidx, cv) for over-cap rows.  ``reduce_scalar``:
    the fused mxm + reduce under a PLUS monoid (the caller guarantees an
    exact integer sum) — returns an int64 device scalar instead of a
    Matrix, never materialising the output planes.  None when the slot
    domain is beyond int32 (the caller runs the fast tier)."""
    mode = _mode(sr)
    kdt, logical = _kdt_for(zt)
    pv = _prep(Ar, Br, ip_h, sr, zt, m, n, mask, desc, mode, kdt)
    if pv is None:
        return None
    wide = int(n) >= NMAX
    comp = bool(desc.mask_complement) if pv["masked"] else False
    fb_rows = pv["fb_rows"]
    out = _pass1(pv, sr, mode, kdt, logical, int(n), comp, reduce_scalar,
                 wide)
    if reduce_scalar:
        if fb_rows.size:
            out = out + classic_rows(fb_rows)[3].to(torch.int64).sum()
        return out
    OK, OV = out
    dev = OK.device
    tb = torch.from_numpy(pv["starts_h"][:m] * SEGW // TILE * TILE).to(dev)
    live = pv["live"]
    jbits, sent = (32, WSENT) if wide else (JB, SENT)
    counts, p_lo, Sx = _counts(OK, tb, pv["rank"], live, jbits, sent)
    fb = None
    if fb_rows.size:
        fb = classic_rows(fb_rows)
        counts[torch.from_numpy(fb_rows).to(dev)] = fb[0].to(counts.dtype)
    indptr = _cat0(counts)
    nnz = int(indptr[-1])                           # host sync: the nnz
    uidx, cv = _pass2(OK, OV, p_lo, live, indptr[:-1], Sx, nnz,
                      LOW32 if wide else (1 << JB) - 1, sent)
    if fb is not None:
        fb_counts, fb_uvec, fb_uidx, fb_cv = fb
        k_in = torch.arange(fb_uidx.numel(), device=dev)
        cstart = _cat0(fb_counts.long())
        rowix = torch.searchsorted(torch.from_numpy(fb_rows).to(dev),
                                   fb_uvec.long())
        dest = indptr[fb_uvec.long()] + (k_in - cstart[rowix])
        uidx[dest] = fb_uidx.to(INDEX)
        cv[dest] = fb_cv.to(cv.dtype)
    cv = cv != 0 if logical else cast(cv, zt)
    return Matrix((m, n), zt, SPARSE, ROW, indptr=indptr.to(INDEX),
                  indices=uidx, values=cv)
