"""mxm / mxv / vxm: C<M> = accum(C, A (+).(x) B) over any semiring
(counterpart of ``graphblas_tpu.ops.mxm``; reference: GB_mxm /
GB_AxB_meta, Source/GB_mxm.c, GB_AxB_meta.c).

Logical transposes are free (orientation metadata), so method selection
reduces to: normalize A to row storage, flip the multiply instead of
materializing a transpose (GB_AxB_meta.c:453), then pick by operand
formats:

  - diagonal operand -> rowscale / colscale
  - dense x dense    -> torch.matmul for plus-times over full operands,
                        chunked broadcast-reduce otherwise
  - sparse x dense   -> SpMV/SpMM.  Plus-times fp32 with at most 8
                        columns rides the hand-written SpMV kernels
                        (planned when Matrix.optimize() cached a plan,
                        unplanned otherwise); the other semirings of
                        the kernels (spmv_kernel) ride the planned ones
                        when a plan is cached; everything else is a
                        row-gather + segmented reduce in torch
  - sparse x sparse  -> ESC SpGEMM (expand-sort-compress): the SELL
                        engine (ops/spgemm_sell.py, sort-reduce kernels
                        K5-K8) when the semiring and type have a kernel,
                        the fast tier (ops/spgemm_fast.py) where SELL
                        declines, else the classic path (int64 key sort +
                        segmented reduce, tiled by row blocks)

The kernel tier is chosen by a predicate only — ``kernels_enabled``, the
dtype, the monoid, and whether a plan is cached — and the kernel wrappers
themselves launch on CUDA tensors and run their plain versions on CPU
tensors.  accum/mask/replace all land in ops/masker.writeback; a sparse
mask that SpGEMM already applied is transplanted (``_mask_done``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..core.convert import _clone
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import (BITMAP, COL, FULL, HYPER, INDEX, ROW, SPARSE,
                           Matrix, Vector)
from ..core.semiring import PLUS_TIMES, Semiring
from ..core.types import cast
from ..kernels import segment as K
from ..kernels import spmv_onehot, spmv_route
from .masker import mask_bits_at_keys, mask_lookup, writeback
from .transpose import logical_transpose, maybe_transpose

_MATMUL_ADD = {"GrB_PLUS"}  # monoids whose dense path can ride matmul
_MATMUL_MULT = {"GrB_TIMES"}

# semiring -> the SpMV kernels' operator names (spmv_kernel)
_ROUTE_ADD = {"GrB_MIN": "min", "GrB_MAX": "max", "GrB_PLUS": "plus"}
_ROUTE_MUL = {"GrB_TIMES": "times", "GrB_PLUS": "plus", "GrB_FIRST": "first",
              "GrB_SECOND": "second", "GrB_ONEB": "pair"}


def _dense(a):
    return a.fmt in (BITMAP, FULL)


def _ztype(sr: Semiring, A, B, out_dtype=None):
    if out_dtype is not None:
        return T.lookup(out_dtype)
    # typed named semirings compute and output in their declared domain
    # (comparator semirings still output the mult's bool ztype; typed
    # positional ones the declared INT32/INT64)
    dt = sr.declared_type
    if dt is not None:
        return dt if sr.mult.positional else (sr.mult.ztype or dt)
    return sr.mult.out_type(A.dtype, B.dtype)


def _positional_product_vals(pos_kind, i, k, j, zt):
    """Semiring-context positional multiply: z = f(a_ik, b_kj) with
    FIRSTI=i, FIRSTJ=k, SECONDI=k, SECONDJ=j."""
    src = {"firsti": i, "firsti1": i + 1, "firstj": k,
           "firstj1": k + 1, "secondi": k, "secondi1": k + 1,
           "secondj": j, "secondj1": j + 1}[pos_kind]
    return src.to(zt.torch_dtype)


def _ident_relabel(i, k, j):
    return i, k, j


def _flip(sr: Semiring) -> Semiring:
    return Semiring(sr.add, sr.mult.flipped(), name=sr.name + "_flip",
                    declared_type=sr.declared_type)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _mask_done(Tm, mask, C, accum):
    """True when SpGEMM already applied the write mask exactly and the
    writeback can transplant (reference: dot3's C pattern is the mask
    pattern, Source/GB_mxm.c:180-199): no accum and no prior C content."""
    if mask is None or not getattr(Tm, "_mask_applied", False):
        return False
    if accum is not None:
        return False
    return C is None or (C.fmt in (SPARSE, HYPER) and C.nvals == 0)


def _writeback(C, mask, accum, Tm, desc, out_dtype, out_class=None):
    if _mask_done(Tm, mask, C, accum):
        CFG.burble("mxm: mask applied in-kernel, transplant writeback")
        return writeback(C, None, accum, Tm,
                         desc.with_(mask_complement=False), out_dtype,
                         out_class=out_class)
    return writeback(C, mask, accum, Tm, desc, out_dtype,
                     out_class=out_class)


def mxm(A: Matrix, B: Matrix, sr: Semiring, *, C=None, mask=None,
        accum=None, desc: Descriptor = NULL, out_dtype=None):
    A = maybe_transpose(A, desc.transpose0)
    B = maybe_transpose(B, desc.transpose1)
    if A.ncols != B.nrows:
        raise E.DimensionMismatch(f"mxm: {A.shape} x {B.shape}")
    if C is not None and C.shape != (A.nrows, B.ncols):
        raise E.DimensionMismatch("mxm: C shape")
    zt = _ztype(sr, A, B, None)
    Tm = _mxm_dispatch(A, B, sr, zt, mask, desc, accum)
    return _writeback(C, mask, accum, Tm, desc, out_dtype)


def mxv(A: Matrix, u: Matrix, sr: Semiring, *, C=None, mask=None,
        accum=None, desc: Descriptor = NULL, out_dtype=None):
    """w<m> = accum(w, A (+).(x) u).  desc.transpose0 transposes A."""
    A = maybe_transpose(A, desc.transpose0)
    if A.ncols != u.nrows:
        raise E.DimensionMismatch(f"mxv: {A.shape} x {u.shape}")
    zt = _ztype(sr, A, u, None)
    Tm = _mxm_dispatch(A, u, sr, zt, mask, desc, accum)
    return _writeback(C, mask, accum, Tm, desc.with_(transpose0=False),
                      out_dtype, out_class=Vector)


def vxm(u: Matrix, A: Matrix, sr: Semiring, *, C=None, mask=None,
        accum=None, desc: Descriptor = NULL, out_dtype=None):
    """w<m> = accum(w, u' (+).(x) A) == mxv(A', u) with the multiply
    flipped (GB_AxB_meta.c:453-468).  Positional multiplies are not
    flipped; the product triple is relabeled instead.  desc.transpose1
    transposes A."""
    A = maybe_transpose(A, desc.transpose1)
    if A.nrows != u.nrows:
        raise E.DimensionMismatch(f"vxm: {u.shape}' x {A.shape}")
    zt = _ztype(sr, u, A, None)
    d2 = desc.with_(transpose0=False, transpose1=False)
    # SpMSpV: u sparse, A sparse by row -> scatter the ~nnz(u)*deg
    # products of A's rows at supp(u) into a dense accumulator (reference:
    # the saxpy SpMSpV of Source/GB_AxB_saxpy.c)
    if (u.fmt in (SPARSE, HYPER) and u.orient == COL
            and A.fmt in (SPARSE, HYPER) and A.orient == ROW
            and not sr.mult.positional and mask is None):
        Tv = _spmspv_scatter(u, A, sr, zt)
        if Tv is not None:
            CFG.burble("vxm: spmspv dense-accumulator path")
            return writeback(C, mask, accum, Tv, d2, out_dtype,
                             out_class=Vector)
        # u is n-by-1 stored by column, so its logical transpose is
        # already the 1-by-n CSR row: a 1-row SpGEMM over A's rows
        ut = logical_transpose(u.to_format(SPARSE, COL))
        CFG.burble("vxm: spmspv path (1-row spgemm, no transpose)")
        Tv = logical_transpose(_spgemm_esc(ut, A, sr, zt, None, d2, accum))
        return writeback(C, mask, accum, Tv, d2, out_dtype,
                         out_class=Vector)
    At = logical_transpose(A)
    if sr.mult.positional:
        sr2 = sr
        relabel = lambda i, k, j: (torch.zeros_like(i), k, i)  # noqa: E731
    else:
        sr2 = _flip(sr)
        relabel = _ident_relabel
    Tm = _mxm_dispatch(At, u, sr2, zt, mask, desc, accum, relabel)
    return _writeback(C, mask, accum, Tm, d2, out_dtype, out_class=Vector)


# ---------------------------------------------------------------------------
# SpMSpV: dense-accumulator saxpy
# ---------------------------------------------------------------------------

_SPMSPV_ADDS = ("GrB_PLUS", "GrB_MIN", "GrB_MAX", "GrB_LOR", "GxB_ANY")


def _spmspv_scatter(u, A, sr, zt):
    """w = u' (x) A with u sparse: expand the products of A's rows at
    supp(u) and scatter them into a dense length-n accumulator under the
    add monoid.  Returns a BITMAP Vector, or None when the monoid/type
    cannot ride a scatter."""
    add_name = sr.add.op.name
    if add_name not in _SPMSPV_ADDS or zt.is_complex or \
            T.wide_unsigned(zt):
        return None
    m = A.ncols
    dev = A.device
    if A.fmt == HYPER:
        A = A.to_format(SPARSE, ROW)
    us = u.to_format(SPARSE)
    ui = us.indices.long()
    if ui.shape[0] == 0:
        return Vector(m, zt, SPARSE, device=dev)
    uv = us._vals_expanded()
    blen = torch.diff(A.indptr).long()[ui]
    pos = spmv_route._repeat_arange(A.indptr.long()[ui], blen)
    if pos.shape[0] == 0:
        return Vector(m, zt, SPARSE, device=dev)
    e = torch.repeat_interleave(torch.arange(ui.shape[0], device=dev), blen,
                                output_size=pos.shape[0])
    j = A.indices.long()[pos]
    logical = zt.is_bool
    kt = T.INT32 if logical else zt
    prod = cast(sr.mult.fn(T.take(uv, e), T.take(A._vals_expanded(), pos)),
                kt)
    pres = torch.zeros(m, dtype=torch.bool, device=dev)
    pres[j] = True
    if add_name == "GrB_PLUS":
        acc = K.ACC.get(kt.torch_dtype, kt.torch_dtype)   # BF16: float32
        y = torch.zeros(m, dtype=acc, device=dev).index_add_(
            0, j, prod.to(acc))
    else:
        ident = sr.add.identity_tensor(kt, dev)
        red = "amin" if add_name == "GrB_MIN" else "amax"
        y = ident.expand(m).clone().scatter_reduce_(0, j, prod, red,
                                                    include_self=True)
        y = torch.where(pres, y, torch.zeros_like(y))
    return Vector(m, zt, BITMAP, values=cast(y, zt)[:, None],
                  bitmap=pres[:, None])


# ---------------------------------------------------------------------------
# method selection (the GB_AxB_meta analog)
# ---------------------------------------------------------------------------

def _is_diagonal(a: Matrix) -> bool:
    """Diagonal-operand detection (reference: GB_AxB_meta.c rowscale/
    colscale selection)."""
    if a.fmt != SPARSE or a.nrows != a.ncols:
        return False
    nnz = int(a.indices.shape[0])
    if nnz != a.nrows:
        return False
    if not bool((torch.diff(a.indptr) == 1).all()):
        return False
    return bool((a.indices.long() == torch.arange(
        nnz, device=a.device)).all())


def _rowscale(D: Matrix, B: Matrix, sr, zt, relabel) -> Matrix:
    """C = D*B with D diagonal: scale B's row-k entries by d[k]."""
    if sr.mult.positional:
        return None
    d = D._vals_expanded()
    Br = B.to_format(SPARSE, ROW)
    nnz = int(Br.indices.shape[0])
    rows = K.expand_rowids(Br.indptr, nnz, B.nrows).long()
    vals = cast(sr.mult.fn(T.take(d, rows), Br._vals_expanded()), zt)
    return _clone(Br, dtype=zt, values=vals, iso=False)


def _colscale(A: Matrix, D: Matrix, sr, zt, relabel) -> Matrix:
    """C = A*D with D diagonal: scale A's column-j entries by d[j]."""
    if sr.mult.positional:
        return None
    d = D._vals_expanded()
    Ar = A.to_format(SPARSE, ROW)
    vals = cast(sr.mult.fn(Ar._vals_expanded(),
                           T.take(d, Ar.indices.long())), zt)
    return _clone(Ar, dtype=zt, values=vals, iso=False)


def _mxm_dispatch(A, B, sr, zt, mask, desc, accum,
                  relabel=_ident_relabel) -> Matrix:
    # diagonal-operand fast paths (reference: GB_rowscale / GB_colscale)
    if not _dense(A) and not _dense(B) and relabel is _ident_relabel:
        if _is_diagonal(A):
            out = _rowscale(A, B, sr, zt, relabel)
            if out is not None:
                CFG.burble("mxm: rowscale (diagonal A)")
                return out
        if _is_diagonal(B):
            out = _colscale(A, B, sr, zt, relabel)
            if out is not None:
                CFG.burble("mxm: colscale (diagonal B)")
                return out
    if desc.axb_method == "dense" or (_dense(A) and _dense(B)):
        CFG.burble("mxm: dense path (%s x %s)", A.fmt, B.fmt)
        return _mxm_dense(A, B, sr, zt, relabel)
    if _dense(B) and not _dense(A):
        CFG.burble("mxm: spmm path (sparse x %s)", B.fmt)
        return _spmm(A, B, sr, zt, relabel)
    if _dense(A) and not _dense(B):
        # C = A*B == (B'*A')' with the multiply flipped
        CFG.burble("mxm: spmm-flip path (%s x sparse)", A.fmt)
        if sr.mult.positional:
            sr2 = sr
            rel2 = lambda i, k, j: relabel(j, k, i)  # noqa: E731
        else:
            sr2 = _flip(sr)
            rel2 = relabel
        Ct = _spmm(logical_transpose(B), logical_transpose(A), sr2, zt,
                   rel2)
        return logical_transpose(Ct)
    CFG.burble("mxm: ESC spgemm path")
    return _spgemm_esc(A, B, sr, zt, mask, desc, accum, relabel)


# ---------------------------------------------------------------------------
# dense x dense
# ---------------------------------------------------------------------------

def _mxm_dense(A, B, sr, zt, relabel=_ident_relabel) -> Matrix:
    av, ap = A.to_dense_pair()
    bv, bp = B.to_dense_pair()
    m, k = A.shape
    n = B.ncols
    dev = A.device
    add_name, mult_name = sr.add.op.name, sr.mult.name
    real = not (zt.is_complex or zt.is_bool or zt.is_integer) \
        and not sr.mult.positional
    if add_name in _MATMUL_ADD and mult_name in _MATMUL_MULT and real:
        CFG.burble("mxm dense: matmul")
        zero = torch.zeros((), dtype=zt.torch_dtype, device=dev)
        cv = torch.matmul(torch.where(ap, cast(av, zt), zero),
                          torch.where(bp, cast(bv, zt), zero))
        if A.fmt == FULL and B.fmt == FULL:
            return Matrix((m, n), zt, FULL, A.orient, values=cv)
        present = torch.matmul(ap.float(), bp.float()) > 0
        return Matrix((m, n), zt, BITMAP, A.orient,
                      values=torch.where(present, cv, zero), bitmap=present)
    CFG.burble("mxm dense: generic broadcast-reduce")
    ident = sr.add.identity_tensor(zt, dev)
    chunk = max(1, min(k, (1 << 22) // max(1, m * max(n, 1))))
    acc = ident.expand((m, n) + zt.shape).clone()
    pres = torch.zeros((m, n), dtype=torch.bool, device=dev)
    for k0 in range(0, k, chunk):
        k1 = min(k, k0 + chunk)
        both = ap[:, k0:k1, None] & bp[None, k0:k1, :]
        if sr.mult.positional:
            ii = torch.arange(m, device=dev)[:, None, None]
            kk = torch.arange(k0, k1, device=dev)[None, :, None]
            jj = torch.arange(n, device=dev)[None, None, :]
            ri, rk, rj = relabel(ii, kk, jj)
            prod = _positional_product_vals(
                sr.mult.positional, *torch.broadcast_tensors(ri, rk, rj), zt)
        else:
            prod = cast(sr.mult.fn(av[:, k0:k1, None], bv[None, k0:k1, :]),
                        zt)
        prod = T.where(both, prod, ident)
        red = _reduce_axis1(prod, sr.add, zt)
        anyp = both.any(dim=1)
        acc = T.where(anyp & pres, cast(sr.add.op.fn(acc, red), zt),
                      T.where(anyp, red, acc))
        pres = pres | anyp
    acc = T.where(pres, acc, torch.zeros((), dtype=zt.torch_dtype,
                                         device=dev))
    return Matrix((m, n), zt, BITMAP, A.orient, values=acc, bitmap=pres)


def _reduce_axis1(prod, add, zt):
    """Reduce axis 1 of a (m, k, n) product block under the add monoid."""
    m, kc, n = prod.shape[:3]
    fs = tuple(prod.shape[3:])          # a struct's field dims
    seg = torch.arange(m * n, device=prod.device).reshape(m, 1, n) \
        .expand(m, kc, n).reshape(-1)
    flat = prod.reshape((-1,) + fs)
    return K.segment_reduce(flat, seg, m * n, add,
                            indices_are_sorted=False).reshape((m, n) + fs)


# ---------------------------------------------------------------------------
# sparse x dense (SpMV / SpMM)
# ---------------------------------------------------------------------------

def _spmm(A: Matrix, B: Matrix, sr, zt, relabel=_ident_relabel) -> Matrix:
    """C(bitmap) = A(sparse) x B(bitmap/full); span ``mxm.spmm``, counter
    ``mxm.spmm_products`` (A's stored entries x B's columns)."""
    with CFG.timed("mxm.spmm", A.device):
        Ar = A.to_format(SPARSE, ROW)
        CFG.count("mxm.spmm_products", int(Ar.indices.shape[0]) * B.ncols)
        return _spmm_rows(Ar, B, sr, zt, relabel)


def _spmm_rows(Ar: Matrix, B: Matrix, sr, zt, relabel) -> Matrix:
    m = Ar.nrows
    dev = Ar.device
    # plus-times fp32 with few dense columns: the SpMV kernels per column
    if (B.ncols <= 8 and B.fmt == FULL and sr.add.op.name == "GrB_PLUS"
            and sr.mult.name == "GrB_TIMES" and not sr.mult.positional
            and zt == T.FP32):
        vals = cast(Ar._vals_expanded(), zt)
        bv = cast(B._vals_expanded(), zt)
        CFG.burble("spmm: spmv x%d", B.ncols)
        y = torch.stack([spmv_arrays(Ar.indptr, Ar.indices, vals,
                                     bv[:, c].contiguous(), m)
                         for c in range(B.ncols)], dim=1)
        # spec pattern: rows of A with no entries are absent
        pres = (torch.diff(Ar.indptr) > 0)[:, None].expand(m, B.ncols)
        return Matrix((m, B.ncols), zt, BITMAP, ROW, values=y,
                      bitmap=pres.contiguous())
    # the other semirings of the SpMV kernels, on a plan cached by
    # Matrix.optimize (spmv_kernel: K3, or K4 for fp64 plus-times)
    if (B.ncols == 1 and B.fmt == FULL and zt in (T.FP32, T.FP64)
            and _route_ops(sr) is not None):
        x = cast(B._vals_expanded(), zt)[:, 0].contiguous()
        y = spmv_kernel(Ar.indptr, Ar.indices, cast(Ar._vals_expanded(), zt),
                        x, m, sr)
        if y is not None:
            pres1 = (torch.diff(Ar.indptr) > 0)[:, None]
            return Matrix((m, 1), zt, BITMAP, ROW, values=y[:, None],
                          bitmap=pres1)
    n = B.ncols
    nnz = int(Ar.indices.shape[0])
    zero = torch.zeros((), dtype=zt.torch_dtype, device=dev)
    if nnz == 0:
        return Matrix((m, n), zt, BITMAP, ROW,
                      values=zero.expand(m, n).clone(),
                      bitmap=torch.zeros((m, n), dtype=torch.bool,
                                         device=dev))
    bv, bp = B.to_dense_pair()
    rows = K.expand_rowids(Ar.indptr, nnz, m)
    cols = Ar.indices.long()
    brow = T.take(bv, cols)                # [nnz, n] gather of B rows
    bpres = bp[cols, :]
    if sr.mult.positional:
        ii = rows.long()[:, None].expand(nnz, n)
        kk = cols[:, None].expand(nnz, n)
        jj = torch.arange(n, device=dev)[None, :].expand(nnz, n)
        ri, rk, rj = relabel(ii, kk, jj)
        prod = _positional_product_vals(sr.mult.positional, ri, rk, rj, zt)
    else:
        prod = cast(sr.mult.fn(Ar._vals_expanded()[:, None], brow), zt)
    prod = T.where(bpres, prod, sr.add.identity_tensor(zt, dev))
    out = K.segment_reduce(prod, rows, m, sr.add, indices_are_sorted=True)
    pres = torch.zeros((m, n), dtype=torch.int32, device=dev)
    pres.index_add_(0, rows.long(), bpres.to(torch.int32))
    pres = pres > 0
    return Matrix((m, n), zt, BITMAP, ROW,
                  values=T.where(pres, out, zero), bitmap=pres)


def vxm_chain(u, A, sr: Semiring, steps: int):
    """K-step vxm pipeline: y0 = u; yk = y(k-1) (+).(x) A.

    Plus-times fp32 with a plan cached on A's CSC arrays (build it with
    ``A.to_format(SPARSE, COL).T.optimize()``) runs the planned kernel
    back to back on a dense carrier, and returns a FULL vector (implicit
    zeros become explicit, the dense-y GraphBLAS idiom); anything else is
    an eager vxm loop."""
    from .. import api
    steps = int(steps)
    if steps <= 0:
        return u
    rp = None
    if (sr.add.op.name == "GrB_PLUS" and sr.mult.name == "GrB_TIMES"
            and not sr.mult.positional and CFG.GLOBAL.kernels_enabled):
        At = A.to_format(SPARSE, COL)
        vals = At._vals_expanded()
        if vals.dtype == torch.float32:
            rp = spmv_route.plan_for(At.indptr, At.indices, vals,
                                     (A.ncols, A.nrows), build=False)
    if rp is not None:
        CFG.burble("vxm_chain: planned x%d", steps)
        x = cast(u.to_dense_1d(0)[0], T.FP32).contiguous()
        for _ in range(steps):
            x = spmv_route.spmv_route(x, rp)
        return Vector.from_dense(x)
    CFG.burble("vxm_chain: eager x%d", steps)
    y = u
    for _ in range(steps):
        y = api.vxm(y, A, sr)
    return y


def _route_ops(sr: Semiring):
    """The SpMV kernels' (add, mul) operator names for ``sr``, or None."""
    ops = (_ROUTE_ADD.get(sr.add.op.name), _ROUTE_MUL.get(sr.mult.name))
    return None if None in ops else ops


def spmv_kernel(indptr, indices, values, x, m: int, sr: Semiring,
                build: bool = False):
    """y = A (+).(x) x over a CSR's arrays on an SpMV kernel, in x's
    dtype (that of ``values``); None where no kernel takes the semiring
    and type, and the caller computes in torch.  The one tier predicate
    of the port's SpMVs (``spmv_arrays``, ``_spmm``, the distributed
    tier's local SpMV), with the kernels on:

      * plus-times fp32: K1 (spmv_route) on a cached plan, else K2
        (spmv_onehot.spmv), which needs none
      * (min|max|plus).(times|plus|first|second|pair) fp32: K3
        (spmv_route_monoid) on a plan
      * plus-times fp64: K4 (spmv_route_ds) on a plan

    Plans come from ``spmv_route.plan_for``; ``build`` builds a missing
    one for K3 and K4 (K2 never waits for one).  Empty rows take the add
    identity on every tier."""
    ops = _route_ops(sr)
    if not CFG.GLOBAL.kernels_enabled or ops is None \
            or x.dtype != values.dtype:
        return None
    plus_times = ops == ("plus", "times")
    if values.dtype == torch.float32:
        rp = spmv_route.plan_for(indptr, indices, values,
                                 (m, int(x.shape[0])),
                                 build=build and not plus_times)
        if plus_times and rp is None:
            CFG.burble("spmv: tier=merge")
            return spmv_onehot.spmv(indptr, indices, values, x, m)
        if plus_times:
            CFG.burble("spmv: tier=route")
            return spmv_route.spmv_route(x, rp)
        if rp is not None:
            CFG.burble("spmv: tier=route_monoid %s_%s", *ops)
            return spmv_route.spmv_route_monoid(x, rp, add=ops[0],
                                                mul=ops[1])
    elif values.dtype == torch.float64 and plus_times:
        rp = spmv_route.plan_for(indptr, indices, values,
                                 (m, int(x.shape[0])), build=build)
        if rp is not None:
            CFG.burble("spmv: tier=route_ds")
            return spmv_route.spmv_route_ds(x, rp)
    return None


def spmv_arrays(indptr, indices, values, x, m: int) -> torch.Tensor:
    """Raw CSR SpMV (plus-times) in the values' dtype: the hot path behind
    the benchmarks and the fused algorithms.  ``spmv_kernel``'s tiers
    (K1, K2, K4), else a gather + index_add_ in torch."""
    x = x.to(values.dtype)
    y = spmv_kernel(indptr, indices, values, x, m, PLUS_TIMES)
    if y is None:
        CFG.burble("spmv: tier=torch")
        y = spmv_onehot.spmv_plain(indptr, indices, values, x, m)
    return y


# ---------------------------------------------------------------------------
# sparse x sparse: ESC SpGEMM (saxpy3 analog)
# ---------------------------------------------------------------------------

SPGEMM_FLOP_BLOCK = 1 << 24   # peak expanded products per row block


def _flop_count(a_cols, b_indptr):
    """Cumulative products per A entry: cumf[e] = sum over entries before
    e of |B(k,:)| (reference: GB_AxB_saxpy3_flopcount.c)."""
    blen = torch.diff(b_indptr.long())
    out = torch.zeros(a_cols.numel() + 1, dtype=torch.int64,
                      device=a_cols.device)
    torch.cumsum(blen[a_cols.long()], 0, out=out[1:])
    return out


def _spgemm_esc(A, B, sr, zt, mask, desc, accum,
                relabel=_ident_relabel) -> Matrix:
    """Marks results of sparse/hyper-masked runs: every internal path
    (SELL's and the fast tier's in-sort tokens, the classic prefilter)
    applies such masks exactly,
    so mxm/mxv/vxm transplant instead of re-masking in writeback."""
    out = _spgemm_esc_impl(A, B, sr, zt, mask, desc, accum, relabel)
    if mask is not None and mask.fmt in (SPARSE, HYPER):
        out._mask_applied = True
    return out


def mxm_reduce_scalar(A, B, sr: Semiring, *, mask=None,
                      desc: Descriptor = NULL):
    """Fused ``reduce(C<M> = A (+).(x) B)`` under a PLUS monoid: the SELL
    engine reduces each block's kept outputs without materialising C
    (reference analog: LAGraph triangle count = dot3 mxm + GrB_reduce).
    Returns an int64 device scalar, or None when the fused path does not
    apply (the caller runs mxm + reduce)."""
    A2 = maybe_transpose(A, desc.transpose0)
    B2 = maybe_transpose(B, desc.transpose1)
    if A2.ncols != B2.nrows:
        raise E.DimensionMismatch(f"mxm: {A2.shape} x {B2.shape}")
    zt = _ztype(sr, A2, B2, None)
    # PAIR: run sums are exact small counts in any type
    int_exact = zt.is_integer or sr.mult.name == "GrB_ONEB"
    if (sr.add.op.name != "GrB_PLUS" or zt.is_bool or zt.is_complex
            or _dense(A2) or _dense(B2) or not int_exact
            or mask is not None and mask.fmt not in (SPARSE, HYPER)):
        # the tiers apply a sparse mask only; mxm's writeback the others
        return None
    d2 = desc.with_(transpose0=False, transpose1=False)
    out = _spgemm_esc_impl(A2, B2, sr, zt, mask, d2, None,
                           reduce_scalar=True)
    return None if out is None or isinstance(out, Matrix) else out


def _spgemm_esc_impl(A, B, sr, zt, mask, desc, accum,
                     relabel=_ident_relabel, reduce_scalar=False):
    """Expand-sort-compress SpGEMM.

    Phase 0 (flop count, one host sync): F = sum over A entries of
    |B(k,:)|.  Tier choice by predicate: the SELL engine
    (ops/spgemm_sell.py) when the semiring, type and monoid have a
    sort-reduce kernel; when SELL declines (its int32 slot domain), the
    fast tier (ops/spgemm_fast.py), as in the JAX package; else the
    classic path here, whose row blocks of at most SPGEMM_FLOP_BLOCK
    products keep peak memory O(block): expand products (searchsorted on
    the cumulative flop array), prefilter by a sparse mask (the dot3
    analog), sort the int64 (i, j) keys and reduce each group under the
    add monoid.  The fused reduce (``reduce_scalar``) exists on SELL
    only; elsewhere it returns None and the caller runs mxm + reduce.

    Spans: ``spgemm.flops`` (phase 0), ``spgemm.fallback`` (rows sent to
    the classic path by SELL or the fast tier), ``spgemm.sortreduce``
    (the classic tier's blocks, as the other tiers' expansion and
    sort-reduce: their module docstrings); counters ``spgemm.sell``,
    ``spgemm.fast``, ``spgemm.classic`` (the tier that ran),
    ``spgemm.sell_declined`` and ``spgemm.fallback_rows``.  Every host
    read and upload is a ``config.blocking_copy``."""
    from . import spgemm_fast as SGF
    from . import spgemm_sell as SGS
    Ar = A.to_format(SPARSE, ROW)
    Br = B.to_format(SPARSE, ROW)
    m = A.nrows
    n = B.ncols
    dev = A.device
    nnzA = int(Ar.indices.shape[0])
    if nnzA == 0 or int(Br.indices.shape[0]) == 0:
        return None if reduce_scalar else \
            Matrix((m, n), zt, SPARSE, ROW, device=dev)
    with CFG.timed("spgemm.flops", dev):
        cumf = _flop_count(Ar.indices, Br.indptr)
        F = int(CFG.blocking_copy(cumf[-1], "cpu"))
    CFG.burble("spgemm: %d flops (nnzA=%d nnzB=%d)", F, nnzA,
               int(Br.indices.shape[0]))
    if F == 0:
        return None if reduce_scalar else \
            Matrix((m, n), zt, SPARSE, ROW, device=dev)
    a_rows = K.expand_rowids(Ar.indptr, nnzA, m).long()
    row_cum = cumf[Ar.indptr.long()]         # products before each row
    masked = mask is not None and mask.fmt in (SPARSE, HYPER)

    def classic_rows(rows, count=False):
        """Over-cap rows (ascending host ids) through the classic path,
        in row blocks of at most SPGEMM_FLOP_BLOCK products.  Returns
        (counts, uvec, uidx, cv); with ``count`` (a PAIR product's fused
        reduce, whose outputs are their product counts) the number of
        products the mask keeps, an int64 device scalar, with no sort."""
        with CFG.timed("spgemm.fallback", dev):
            CFG.count("spgemm.fallback_rows", rows.size)
            rows_d = CFG.blocking_copy(rows, dev)
            lo = row_cum[rows_d]
            cnt = row_cum[rows_d + 1] - lo
            cnt_h = CFG.blocking_copy(cnt, "cpu").numpy()
            cut = _row_blocks(cnt_h)
            blocks = [(b0, b1, int(cnt_h[b0:b1].sum()))
                      for b0, b1 in zip(cut[:-1], cut[1:])]
            if count:
                kept = torch.zeros((), dtype=torch.int64, device=dev)
                bits = mask_lookup(mask, n, ROW, desc) if masked else None
                for b0, b1, f in blocks:
                    if bits is None:
                        kept += f
                        continue
                    p = _ranges(lo[b0:b1], cnt[b0:b1], f)
                    kept += bits(_spgemm_keys_at(Ar, Br, a_rows, cumf, p,
                                                 n)[0]).sum()
                return kept
            parts = []
            for b0, b1, f in blocks:
                p = _ranges(lo[b0:b1], cnt[b0:b1], f)
                keys, prod = _spgemm_expand_at(Ar, Br, a_rows, cumf, p, sr,
                                               zt, n, relabel)
                parts.append(_spgemm_block(keys, prod, mask, desc, sr, n))
            uvec, uidx, cv = (torch.cat(q) for q in zip(*parts))
            counts = torch.zeros(rows.size, dtype=torch.int64, device=dev)
            counts.index_add_(0, torch.searchsorted(rows_d, uvec.long()),
                              torch.ones_like(uvec, dtype=torch.int64))
            return counts, uvec.long(), uidx, cv

    why = SGS.ineligible(sr, zt, n)
    if why is None:
        ip_h = CFG.blocking_copy(Ar.indptr, "cpu").numpy().astype(np.int64)
        T_ = SGS.spgemm_sell(Ar, Br, ip_h, sr, zt, m, n, mask, desc,
                             classic_rows, reduce_scalar=reduce_scalar)
        if T_ is not None:
            CFG.count("spgemm.sell")
            return T_
        CFG.count("spgemm.sell_declined")
        CFG.burble("spgemm: SELL declined (slot domain)")
    if reduce_scalar:
        return None          # no fused path; the caller runs mxm + reduce
    row_cum_h = CFG.blocking_copy(row_cum, "cpu").numpy()
    if why is None:
        CFG.count("spgemm.fast")
        CFG.burble("spgemm: fast sort-reduce tier, %d flops", F)
        return SGF.spgemm_esc_fast(Ar, Br, cumf, ip_h, row_cum_h, sr, zt, m,
                                   n, mask, desc, classic_rows,
                                   SPGEMM_FLOP_BLOCK)
    CFG.count("spgemm.classic")
    CFG.burble("spgemm: classic ESC (%s)", why)
    with CFG.timed("spgemm.sortreduce", dev):
        cut = _row_blocks(np.diff(row_cum_h))
        CFG.burble("spgemm: %d row blocks", len(cut) - 1)
        parts = []
        for r0, r1 in zip(cut[:-1], cut[1:]):
            f0, f1 = int(row_cum_h[r0]), int(row_cum_h[r1])
            if f1 > f0:
                keys, prod = _spgemm_expand(Ar, Br, a_rows, cumf, f0,
                                            f1 - f0, sr, zt, n, relabel)
                parts.append(_spgemm_block(keys, prod, mask, desc, sr, n))
        uvec, uidx, cv = (torch.cat(q) for q in zip(*parts))
        indptr = K.indptr_from_sorted(uvec, m, INDEX)
    return Matrix((m, n), zt, SPARSE, ROW, indptr=indptr, indices=uidx,
                  values=cv)


def _ranges(lo, cnt, total: int):
    """concat(arange(lo[r], lo[r] + cnt[r]) for each r), ``total`` long:
    each element finds its range by a binary search over the ranges'
    ends (torch's repeat_interleave walks a range in one thread, serially
    through a hub row's millions of products)."""
    ends = torch.cumsum(cnt, 0)
    idx = torch.arange(total, dtype=lo.dtype, device=lo.device)
    r = torch.searchsorted(ends, idx, right=True)
    return lo[r] + idx - (ends - cnt)[r]


def _row_blocks(cnt):
    """Cut rows (host product counts) into consecutive blocks of at most
    SPGEMM_FLOP_BLOCK products; a larger row stays alone (splitting one
    row would break its dedup).  Returns the cut points."""
    cum = np.concatenate([[0], np.cumsum(cnt)])
    cut = [0]
    while cut[-1] < cnt.size:
        r0 = cut[-1]
        r1 = int(np.searchsorted(cum, cum[r0] + SPGEMM_FLOP_BLOCK,
                                 side="right")) - 1
        cut.append(max(r1, r0 + 1))
    return cut


def _spgemm_block(keys, prod, mask, desc, sr, n: int):
    """One ESC pass over a block of expanded products: sparse-mask
    prefilter, int64 key sort, segmented reduce under the add monoid;
    returns (row ids, column ids, values) in CSR order."""
    if mask is not None and mask.fmt in (SPARSE, HYPER):
        eff = mask_bits_at_keys(mask, keys, n, ROW, desc)
        kept, (keys, prod) = K.compact(eff, keys, prod)
        CFG.burble("spgemm: mask prefilter -> %d products", kept)
    skeys, order = torch.sort(keys)
    gid, ng = K.group_ids(skeys)
    cv = K.segment_reduce(T.take(prod, order), gid, ng, sr.add)
    ukeys = torch.zeros(ng, dtype=skeys.dtype, device=skeys.device)
    ukeys[gid] = skeys
    uvec, uidx = K.key_split(ukeys, n)
    return uvec, uidx, cv


def _spgemm_expand(Ar, Br, a_rows, cumf, f0: int, F: int, sr, zt, n: int,
                   relabel=_ident_relabel):
    """Expansion of the F consecutive products from global index f0."""
    p = torch.arange(f0, f0 + F, dtype=torch.int64, device=cumf.device)
    return _spgemm_expand_at(Ar, Br, a_rows, cumf, p, sr, zt, n, relabel)


def _spgemm_keys_at(Ar, Br, a_rows, cumf, p, n: int):
    """(int64 keys i * n + j, A entry e, B position) of global product
    indices ``p`` (ascending): the A entry of each product by
    searchsorted on cumf, then its B position."""
    nnzA = Ar.indices.shape[0]
    e = torch.searchsorted(cumf[1:], p, right=True).clamp(max=nnzA - 1)
    off = (p - cumf[e]).clamp(min=0)
    ka = Ar.indices.long()[e]
    b_pos = (Br.indptr.long()[ka] + off).clamp(max=Br.indices.shape[0] - 1)
    return a_rows[e] * n + Br.indices.long()[b_pos], e, b_pos


def _spgemm_expand_at(Ar, Br, a_rows, cumf, p, sr, zt, n: int,
                      relabel=_ident_relabel):
    """Expansion of global product indices ``p`` (ascending): the int64
    key i * n + j of each product (``_spgemm_keys_at``) with the product
    value."""
    mult = sr.mult
    keys, e, b_pos = _spgemm_keys_at(Ar, Br, a_rows, cumf, p, n)
    if mult.positional:
        i, j = keys // n, keys % n
        ri, rk, rj = relabel(i, Ar.indices.long()[e], j)
        prod = _positional_product_vals(mult.positional, ri, rk, rj, zt)
    else:
        prod = cast(mult.fn(T.take(Ar._vals_expanded(), e),
                            T.take(Br._vals_expanded(), b_pos)), zt)
    return keys, prod
