"""Fast SpGEMM tier: ESC with fill-forward expansion into per-row sort
classes (counterpart of ``graphblas_tpu.ops.spgemm_fast``; reference: the
saxpy3 Gustavson/hash tasks, Source/GB_AxB_saxpy3_template.c:108-484).
ops/mxm.py takes it for the products the SELL engine declines (its int32
slot domain), as the JAX package does.

Each output row's products, plus its mask entries when a sparse mask is
given, pad to the smallest sort class C in ``sortreduce.CAPS`` (128 ...
32768) that holds them.  Rows are cut into blocks of at most
``flop_block`` padded slots; per block and class:

  * run starts: for each A entry e = (i, k) of the class's rows, the slot
    where its run of |B(k,:)| products starts (row slot * C + products of
    the row before e) and two packed int64 words (loc << 32) | payload
    carrying (a) the biased offset from the slot to B(k,:)'s first
    position and (b) the bits of A's value; loc ascends with the slot;
  * fill-forward: a scatter-max of the words at the run starts and one
    running max (``spgemm_sell._cummax``) give every slot its run's words,
    so b_pos = offset + slot, j = B.indices[b_pos], b = B.values[b_pos];
  * the mask as in-sort tokens (the dot3 analog): the mask's column ids
    extend B's index array and each masked row gets one more run, its
    tokens, after its products; K6 keeps a group by token presence;
  * sort-reduce: K5 (``sort_reduce_rows``) or K6 (``_tok``) at C;
  * direct placement: each row's kept outputs sit in order at its
    run-end slots, so the destination is indptr[row] plus the prefix
    count of kept slots in the row.

Rows whose load exceeds the top class take the classic ESC path of
ops/mxm.py (the ``classic_rows`` callback), placed by row id into the
same block.  The JAX tier builds the run starts on the host in numpy;
the port builds them on the device from per-row arrays (the host keeps
the per-row classes and the block cut).  What exists only for XLA is not
carried over: the jit cache, the power-of-two padding of the entry
arrays and of the row counts, and the ``GB_SPGEMM_DEBUG`` stage timer
(burble reports the blocks and the rows and padded slots per class).

Spans: ``spgemm.sortreduce`` per block (its classes' expansion and
sort-reduce, as SELL's pass 1), with CUDA events on a card; the
fallback rows open ops/mxm.py's ``spgemm.fallback``.  Every host read
and upload is a ``config.blocking_copy`` (counted ``host_syncs``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config as CFG
from ..core import types as T
from ..core.matrix import HYPER, INDEX, ROW, SPARSE, Matrix
from ..core.types import cast
from ..kernels import sortreduce as SRD
from ..kernels.spmv_route import _repeat_arange
from . import spgemm_sell as SGS

# payload bias: the offset b_start - slot + BIAS lies in [0, 2^32) while
# a class's slot domain stays below BIAS and B's index array below
# 2^32 - BIAS
BIAS = 1 << 28
LOW32 = (1 << 32) - 1
SENT = SRD.SENTINEL


def operand_arrays(Ar, Br, sr, zt, kdt):
    """Arrays every block reads (the JAX tier's ``host_arrays``, kept on
    the device here): A's column ids, the low 32 bits of A's values in
    the kernel's value type (None unless the multiply reads them), B's
    row pointers, and B's values as the multiply reads them (None
    unless it does)."""
    mode = SGS._mode(sr)
    avb = bv = None
    if mode in ("first", "general"):
        av = Ar._vals_expanded()
        av = SGS._as_products(av, zt, kdt) if mode == "first" \
            else cast(av, T.lookup(kdt))
        avb = av.contiguous().view(torch.int32).long() & LOW32
    if mode in ("second", "general"):
        b = Br._vals_expanded()
        bv = SGS._as_products(b, zt, kdt) if mode == "second" \
            else cast(b, T.lookup(kdt))
    return Ar.indices.long(), avb, Br.indptr.long(), bv


def _low32_as(w, kdt):
    """The low 32 bits of int64 words as ``kdt`` (int32 or float32)."""
    v = w & LOW32
    v = torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)
    return v.view(torch.float32) if kdt == torch.float32 else v


def spgemm_esc_fast(Ar, Br, cumf, ip_h, row_cum_h, sr, zt, m, n, mask, desc,
                    classic_rows, flop_block):
    """C = A*B under ``sr`` with the optional sparse mask, as a CSR Matrix.
    Its eligibility is the SELL engine's (``spgemm_sell.ineligible``): the
    JAX tier's predicate cut to the semirings and types the port's
    kernels implement.

    Ar/Br: CSR operands on one device; cumf: products before each A entry
    (device); ip_h, row_cum_h: host copies of A's indptr and of cumf at
    row starts; classic_rows(rows) -> (counts, uvec, uidx, cv) for rows
    over the top class (ascending global host ids)."""
    kdt, logical = SGS._kdt_for(zt)
    dev = Ar.device
    ai, avb, bp, bv = operand_arrays(Ar, Br, sr, zt, kdt)
    masked = mask is not None and mask.fmt in (SPARSE, HYPER)
    nnzB = int(Br.indices.shape[0])
    BiX = Br.indices
    mip_h = None
    if masked:
        # mask entries become in-sort tokens; a valued mask filters to its
        # effective structure first
        Mr = mask.to_format(SPARSE, ROW)
        mip = Mr.indptr.long()
        mi = Mr.indices
        if not desc.mask_structure:
            keep = Mr._vals_expanded() != 0
            if not bool(keep.all()):
                mip = SGS._cat0(keep.long())[mip]
                mi = mi[keep]
        mip_h = CFG.blocking_copy(mip, "cpu").numpy()
        BiX = torch.cat([BiX, mi.to(BiX.dtype)])
        if bv is not None:      # token positions read identity values
            bv = torch.cat([bv, bv.new_zeros(BiX.numel() - nnzB)])
    if BiX.numel() + BIAS >= (1 << 32):
        raise ValueError("spgemm-fast: B's index array beyond the payload")
    # block split on PADDED slot cost (a row pads to its class), fallback
    # rows at their raw products
    flops = np.diff(row_cum_h)
    mdeg = None if mip_h is None else np.diff(mip_h)
    load = flops if mdeg is None else flops + np.where(flops > 0, mdeg, 0)
    caps = np.asarray(SRD.CAPS, np.int64)
    cls = np.searchsorted(caps, load)
    cls[flops == 0] = -1
    top = cls >= len(caps)
    pad_cost = np.where(top, flops, caps[np.clip(cls, 0, len(caps) - 1)])
    pad_cost[flops == 0] = 0
    pad_cum = np.zeros(m + 1, np.int64)
    np.cumsum(pad_cost, out=pad_cum[1:])
    starts = [0]
    while starts[-1] < m:
        r0 = starts[-1]
        r1 = int(np.searchsorted(pad_cum, pad_cum[r0] + flop_block,
                                 side="right")) - 1
        starts.append(max(r1, r0 + 1))
    CFG.burble("spgemm-fast: %d row blocks (scan-expand)", len(starts) - 1)
    ctx = dict(ai=ai, avb=avb, bp=bp, bv=bv, BiX=BiX, nnzB=nnzB,
               cumf=cumf, ip_h=ip_h, row_cum_h=row_cum_h, mip_h=mip_h,
               mdeg=mdeg, flops=flops, cls=cls, load=load, sr=sr, zt=zt,
               kdt=kdt, logical=logical,
               comp=bool(desc.mask_complement) if masked else False,
               masked=masked, classic_rows=classic_rows, dev=dev)
    counts, idxs, cvs = [], [], []
    for r0, r1 in zip(starts[:-1], starts[1:]):
        cnt, uidx, cv = _block(ctx, r0, r1)
        counts.append(cnt)
        idxs.append(uidx)
        cvs.append(cv)
    for ci, C in enumerate(SRD.CAPS):
        rows = int((cls == ci).sum())
        if rows:
            CFG.burble("spgemm-fast: class C=%d: %d rows, %d padded slots",
                       C, rows, rows * C)
    CFG.burble("spgemm-fast: %d fallback rows (%d products) -> classic",
               int(top.sum()), int(flops[top].sum()))
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.concatenate(counts), out=indptr[1:])
    if indptr[-1] >= (1 << 31):
        raise ValueError(f"spgemm-fast: {indptr[-1]} outputs exceed the "
                         "int32 index type")
    uidx = torch.cat(idxs)
    idxs.clear()
    cv = torch.cat(cvs)
    cvs.clear()
    return Matrix((m, n), zt, SPARSE, ROW,
                  indptr=CFG.blocking_copy(indptr.astype(np.int32), dev),
                  indices=uidx, values=cv)


def _class_runs(ctx, rows, C):
    """Run starts of one class: (pos, packed1, packed2 or None, flopc)
    on the device, rows ascending global ids."""
    dev, ip_h, mip_h = ctx["dev"], ctx["ip_h"], ctx["mip_h"]
    Rc = rows.size
    deg = ip_h[rows + 1] - ip_h[rows]
    has_tok = (ctx["mdeg"][rows] > 0) if mip_h is not None \
        else np.zeros(Rc, bool)
    deg2 = deg + has_tok
    cum0 = np.zeros(Rc, np.int64)
    np.cumsum(deg[:-1], out=cum0[1:])
    cum2 = np.zeros(Rc, np.int64)
    np.cumsum(deg2[:-1], out=cum2[1:])
    d = lambda a: CFG.blocking_copy(  # noqa: E731
        np.ascontiguousarray(a, np.int64), dev)
    deg_d = d(deg)
    E = int(deg.sum())
    e_idx = _repeat_arange(d(ip_h[rows]), deg_d)
    rowslot = torch.repeat_interleave(torch.arange(Rc, device=dev), deg_d,
                                      output_size=E)
    within = torch.arange(E, device=dev) - d(cum0)[rowslot]
    c_start = ctx["cumf"][e_idx] - d(ctx["row_cum_h"][rows])[rowslot]
    pos = rowslot * C + c_start
    adj = ctx["bp"][ctx["ai"][e_idx]] - pos + BIAS
    # run-start ranks ascend with pos; a row's tokens come after its
    # products
    loc = (d(cum2)[rowslot] + within + 1) << 32
    p1 = loc | adj
    p2 = None if ctx["avb"] is None else loc | ctx["avb"][e_idx]
    if has_tok.any():
        t = np.flatnonzero(has_tok)
        pos_t = t * C + ctx["flops"][rows[t]]
        adj_t = ctx["nnzB"] + mip_h[rows[t]] - pos_t + BIAS
        loc_t = d((cum2[t] + deg[t] + 1) << 32)
        pos = torch.cat([pos, d(pos_t)])
        p1 = torch.cat([p1, loc_t | d(adj_t)])
        if p2 is not None:
            p2 = torch.cat([p2, loc_t])
    return pos, p1, p2, d(ctx["load"][rows])


def _fill(pos, words, D: int):
    """Every slot of a D-slot domain gets the word of the latest run that
    starts at or before it: a scatter-max at the run starts (a zero-length
    run shares its start with the next run, whose larger loc wins), then
    one running max.  A zero-length run that ends a full row (exactly C
    products) starts at the next row's slot 0, which is D for the last row:
    the buffer has one more slot to take those writes, and drops it (the
    JAX tier's ``mode="drop"``)."""
    buf = torch.full((D + 1,), -1, dtype=torch.int64, device=pos.device)
    return SGS._cummax(buf.scatter_reduce_(0, pos, words, "amax")[:D])


def _class_sort(ctx, rows, C):
    """Expansion and sort-reduce of one class: the (okeys, ovals) run-end
    planes of len(rows) runs of C slots."""
    dev, kdt, logical = ctx["dev"], ctx["kdt"], ctx["logical"]
    sr, BiX, bv = ctx["sr"], ctx["BiX"], ctx["bv"]
    D = rows.size * C
    if D >= BIAS:
        raise ValueError("spgemm-fast: class domain exceeds the payload bias")
    pos, p1, p2, flopc = _class_runs(ctx, rows, C)
    slot = torch.arange(D, device=dev)
    b_pos = ((_fill(pos, p1, D) & LOW32) - BIAS + slot) \
        .clamp_(0, BiX.numel() - 1)
    valid = (torch.arange(C, device=dev)[None, :] < flopc[:, None]) \
        .reshape(-1)
    mode = SGS._mode(sr)
    if mode == "pair":
        prod = torch.ones(D, dtype=kdt, device=dev)
    elif mode == "first":
        prod = _low32_as(_fill(pos, p2, D), kdt)
    elif mode == "second":
        prod = bv[b_pos]
    else:
        prod = SGS._as_products(
            sr.mult.fn(_low32_as(_fill(pos, p2, D), kdt), bv[b_pos]),
            ctx["zt"], kdt)
    ident_np = sr.add.identity_for(np.bool_ if logical else
                                   T.lookup(kdt).np_dtype)
    ident = torch.tensor(int(ident_np) if logical else ident_np.item(),
                         dtype=kdt, device=dev)
    keys = torch.where(valid, BiX[b_pos].to(torch.int32), SENT)
    prod = torch.where(valid, prod, ident)
    if not ctx["masked"]:
        return SRD.sort_reduce_rows(keys, prod.contiguous(), C, sr.add,
                                    logical=logical)
    tok = b_pos >= ctx["nnzB"]
    prod = torch.where(tok, ident, prod).contiguous()
    tx = torch.where(valid, torch.where(tok, 1, 2), 0).to(torch.int32)
    return SRD.sort_reduce_rows_tok(keys, prod, tx, C, sr.add,
                                    want_token=not ctx["comp"],
                                    logical=logical)


def _block(ctx, r0, r1):
    """Rows [r0, r1): (host per-row output counts, column ids, values)."""
    dev, zt, logical = ctx["dev"], ctx["zt"], ctx["logical"]
    cls = ctx["cls"][r0:r1]
    counts = torch.zeros(r1 - r0, dtype=torch.int64, device=dev)
    streams = []
    with CFG.timed("spgemm.sortreduce", dev):
        for ci, C in enumerate(SRD.CAPS):
            sel = np.flatnonzero(cls == ci)
            if sel.size == 0:
                continue
            ok, ov = _class_sort(ctx, sel + r0, C)
            kept = ok.reshape(sel.size, C) != SENT
            sel_d = CFG.blocking_copy(sel, dev)
            counts[sel_d] = kept.sum(1)
            streams.append((ok, ov, kept, sel_d))
    fb = np.flatnonzero(cls == len(SRD.CAPS))
    fbo = None
    if fb.size:
        fbo = ctx["classic_rows"](fb + r0)
        counts[CFG.blocking_copy(fb, dev)] = fbo[0].to(torch.int64)
    indptr = SGS._cat0(counts)
    counts_h = CFG.blocking_copy(counts, "cpu").numpy()
    nnz = int(counts_h.sum())
    uidx = torch.zeros(nnz, dtype=INDEX, device=dev)
    cv = torch.zeros(nnz, dtype=zt.torch_dtype, device=dev)
    for ok, ov, kept, sel_d in streams:
        # kept outputs sit in order at their run ends: the destination is
        # the row's start plus the prefix count of kept slots in the row
        dest = (indptr[sel_d][:, None] + torch.cumsum(kept, 1) - 1)[kept]
        uidx[dest] = ok.reshape(kept.shape)[kept].to(INDEX)
        v = ov.reshape(kept.shape)[kept]
        cv[dest] = (v != 0) if logical else cast(v, zt)
    if fbo is not None:
        fb_counts, fb_uvec, fb_uidx, fb_cv = fbo
        k_in = torch.arange(fb_uidx.numel(), device=dev)
        cstart = SGS._cat0(fb_counts.long())
        rowix = torch.searchsorted(CFG.blocking_copy(fb + r0, dev),
                                   fb_uvec.long())
        dest = indptr[fb_uvec.long() - r0] + (k_in - cstart[rowix])
        uidx[dest] = fb_uidx.to(INDEX)
        cv[dest] = fb_cv.to(cv.dtype)
    return counts_h, uidx, cv
