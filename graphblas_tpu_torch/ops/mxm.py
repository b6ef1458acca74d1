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
                        unplanned otherwise); min/max semirings ride the
                        planned kernel when a plan is cached; everything
                        else is a row-gather + segmented reduce in torch
  - sparse x sparse  -> ESC SpGEMM, not yet ported (raises)

The kernel tier is chosen by a predicate only — ``kernels_enabled``, the
dtype, and whether a plan is cached — and the kernel wrappers themselves
launch on CUDA tensors and run their plain versions on CPU tensors.
accum/mask/replace all land in ops/masker.writeback.
"""

from __future__ import annotations

import torch

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..core.convert import _clone
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import (BITMAP, COL, FULL, HYPER, ROW, SPARSE, Matrix,
                           Vector)
from ..core.semiring import Semiring
from ..core.types import cast
from ..kernels import segment as K
from ..kernels import spmv_onehot, spmv_route
from .masker import writeback
from .transpose import logical_transpose, maybe_transpose

_MATMUL_ADD = {"GrB_PLUS"}  # monoids whose dense path can ride matmul
_MATMUL_MULT = {"GrB_TIMES"}

# semiring -> planned-kernel operator names (the route monoid tier)
_ROUTE_ADD = {"GrB_MIN": "min", "GrB_MAX": "max"}
_ROUTE_MUL = {"GrB_TIMES": "times", "GrB_PLUS": "plus", "GrB_FIRST": "first",
              "GrB_SECOND": "second", "GrB_ONEB": "pair"}


def _dense(a):
    return a.fmt in (BITMAP, FULL)


def _ztype(sr: Semiring, A, B, out_dtype=None):
    if out_dtype is not None:
        return T.lookup(out_dtype)
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
    return Semiring(sr.add, sr.mult.flipped(), name=sr.name + "_flip")


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

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
    return writeback(C, mask, accum, Tm, desc, out_dtype)


def mxv(A: Matrix, u: Matrix, sr: Semiring, *, C=None, mask=None,
        accum=None, desc: Descriptor = NULL, out_dtype=None):
    """w<m> = accum(w, A (+).(x) u).  desc.transpose0 transposes A."""
    A = maybe_transpose(A, desc.transpose0)
    if A.ncols != u.nrows:
        raise E.DimensionMismatch(f"mxv: {A.shape} x {u.shape}")
    zt = _ztype(sr, A, u, None)
    Tm = _mxm_dispatch(A, u, sr, zt, mask, desc, accum)
    return writeback(C, mask, accum, Tm, desc.with_(transpose0=False),
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
        raise NotImplementedError("SpGEMM: see ROADMAP")
    At = logical_transpose(A)
    if sr.mult.positional:
        sr2 = sr
        relabel = lambda i, k, j: (torch.zeros_like(i), k, i)  # noqa: E731
    else:
        sr2 = _flip(sr)
        relabel = _ident_relabel
    Tm = _mxm_dispatch(At, u, sr2, zt, mask, desc, accum, relabel)
    return writeback(C, mask, accum, Tm, d2, out_dtype, out_class=Vector)


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
    if add_name not in _SPMSPV_ADDS or zt.is_complex:
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
    prod = cast(sr.mult.fn(uv[e], A._vals_expanded()[pos]), kt)
    pres = torch.zeros(m, dtype=torch.bool, device=dev)
    pres[j] = True
    if add_name == "GrB_PLUS":
        y = torch.zeros(m, dtype=kt.torch_dtype, device=dev).index_add_(
            0, j, prod)
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
    vals = cast(sr.mult.fn(d[rows], Br._vals_expanded()), zt)
    return _clone(Br, dtype=zt, values=vals, iso=False)


def _colscale(A: Matrix, D: Matrix, sr, zt, relabel) -> Matrix:
    """C = A*D with D diagonal: scale A's column-j entries by d[j]."""
    if sr.mult.positional:
        return None
    d = D._vals_expanded()
    Ar = A.to_format(SPARSE, ROW)
    vals = cast(sr.mult.fn(Ar._vals_expanded(), d[Ar.indices.long()]), zt)
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
    raise NotImplementedError("SpGEMM: see ROADMAP")


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
    acc = ident.expand(m, n).clone()
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
        prod = torch.where(both, prod, ident)
        red = _reduce_axis1(prod, sr.add, zt)
        anyp = both.any(dim=1)
        acc = torch.where(anyp & pres, cast(sr.add.op.fn(acc, red), zt),
                          torch.where(anyp, red, acc))
        pres = pres | anyp
    acc = torch.where(pres, acc, torch.zeros((), dtype=zt.torch_dtype,
                                             device=dev))
    return Matrix((m, n), zt, BITMAP, A.orient, values=acc, bitmap=pres)


def _reduce_axis1(prod, add, zt):
    """Reduce axis 1 of a (m, k, n) product block under the add monoid."""
    m, kc, n = prod.shape
    seg = torch.arange(m * n, device=prod.device).reshape(m, 1, n) \
        .expand(m, kc, n).reshape(-1)
    flat = prod.reshape(-1)
    return K.segment_reduce(flat, seg, m * n, add,
                            indices_are_sorted=False).reshape(m, n)


# ---------------------------------------------------------------------------
# sparse x dense (SpMV / SpMM)
# ---------------------------------------------------------------------------

def _spmm(A: Matrix, B: Matrix, sr, zt, relabel=_ident_relabel) -> Matrix:
    """C(bitmap) = A(sparse) x B(bitmap/full)."""
    Ar = A.to_format(SPARSE, ROW)
    m = A.nrows
    dev = A.device
    # plus-times fp32 with few dense columns: the SpMV kernels per column
    if (B.ncols <= 8 and B.fmt == FULL and sr.add.op.name == "GrB_PLUS"
            and sr.mult.name == "GrB_TIMES" and not sr.mult.positional
            and zt == T.FP32):
        vals = cast(Ar._vals_expanded(), zt)
        bv = cast(B._vals_expanded(), zt)
        rp = None
        if CFG.GLOBAL.kernels_enabled:
            rp = spmv_route.plan_for(Ar.indptr, Ar.indices, vals,
                                     (m, B.nrows), build=False)
        if rp is not None:
            CFG.burble("spmm: planned spmv x%d", B.ncols)
            y = _narrow_spmm_route(bv, rp)
        else:
            CFG.burble("spmm: spmv x%d", B.ncols)
            y = torch.stack([spmv_arrays(Ar.indptr, Ar.indices, vals,
                                         bv[:, c].contiguous(), m)
                             for c in range(B.ncols)], dim=1)
        # spec pattern: rows of A with no entries are absent
        pres = (torch.diff(Ar.indptr) > 0)[:, None].expand(m, B.ncols)
        return Matrix((m, B.ncols), zt, BITMAP, ROW, values=y,
                      bitmap=pres.contiguous())
    # semiring-generic planned tier: (min|max).(plus|times|first|second|
    # pair) fp32 SpMV when a plan is cached (Matrix.optimize)
    route_add = _ROUTE_ADD.get(sr.add.op.name)
    route_mul = _ROUTE_MUL.get(sr.mult.name)
    if (B.ncols == 1 and B.fmt == FULL and route_add and route_mul
            and not sr.mult.positional and zt == T.FP32
            and CFG.GLOBAL.kernels_enabled):
        vals32 = cast(Ar._vals_expanded(), zt)
        rp = spmv_route.plan_for(Ar.indptr, Ar.indices, vals32,
                                 (A.nrows, B.nrows), build=False)
        if rp is not None:
            CFG.burble("spmv: tier=route_monoid %s_%s", route_add,
                       route_mul)
            x = cast(B._vals_expanded(), zt)[:, 0].contiguous()
            y = spmv_route.spmv_route_monoid(x, rp, add=route_add,
                                             mul=route_mul)
            pres1 = (torch.diff(Ar.indptr) > 0)[:, None]
            return Matrix((A.nrows, 1), zt, BITMAP, ROW, values=y[:, None],
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
    brow = bv[cols, :]                     # [nnz, n] gather of B rows
    bpres = bp[cols, :]
    if sr.mult.positional:
        ii = rows.long()[:, None].expand(nnz, n)
        kk = cols[:, None].expand(nnz, n)
        jj = torch.arange(n, device=dev)[None, :].expand(nnz, n)
        ri, rk, rj = relabel(ii, kk, jj)
        prod = _positional_product_vals(sr.mult.positional, ri, rk, rj, zt)
    else:
        prod = cast(sr.mult.fn(Ar._vals_expanded()[:, None], brow), zt)
    prod = torch.where(bpres, prod, sr.add.identity_tensor(zt, dev))
    out = K.segment_reduce(prod, rows, m, sr.add, indices_are_sorted=True)
    pres = torch.zeros((m, n), dtype=torch.int32, device=dev)
    pres.index_add_(0, rows.long(), bpres.to(torch.int32))
    pres = pres > 0
    return Matrix((m, n), zt, BITMAP, ROW,
                  values=torch.where(pres, out, zero), bitmap=pres)


def _narrow_spmm_route(bv, plan) -> torch.Tensor:
    """``ncols`` planned SpMVs, one per dense column (narrow SpMM C = A*F;
    reference workload dobench C=S*F)."""
    return torch.stack([spmv_route.spmv_route(bv[:, c].contiguous(), plan)
                        for c in range(bv.shape[1])], dim=1)


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


def spmv_arrays(indptr, indices, values, x, m: int) -> torch.Tensor:
    """Raw CSR SpMV (plus-times): the hot path behind the benchmarks and
    the fused algorithms.  Tiers, chosen by predicate only:

      * kernels on, fp32, plan cached   -> spmv_route (planned kernel)
      * kernels on, fp32, no plan       -> spmv_onehot.spmv (row-warp)
      * kernels on, fp64, plan cached   -> spmv_route_ds (fp64 planned)
      * otherwise                       -> gather + index_add_ in torch
    """
    shape = (m, int(x.shape[0]))
    if CFG.GLOBAL.kernels_enabled and values.dtype == torch.float32:
        rp = spmv_route.plan_for(indptr, indices, values, shape,
                                 build=False)
        if rp is not None:
            CFG.burble("spmv: tier=route")
            return spmv_route.spmv_route(x.to(torch.float32), rp)
        CFG.burble("spmv: tier=rowwarp")
        return spmv_onehot.spmv(indptr, indices, values,
                                x.to(torch.float32), m)
    if CFG.GLOBAL.kernels_enabled and values.dtype == torch.float64:
        rp = spmv_route.plan_for(indptr, indices, values, shape,
                                 build=False)
        if rp is not None:
            CFG.burble("spmv: tier=route_ds")
            return spmv_route.spmv_route_ds(x.to(torch.float64), rp)
    CFG.burble("spmv: tier=torch")
    return spmv_onehot.spmv_plain(indptr, indices, values,
                                  x.to(values.dtype), m)
