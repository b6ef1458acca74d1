"""accum/mask write-back: C<M> = accum(C, T) (counterpart of
``graphblas_tpu.ops.masker``; reference: Source/GB_accum_mask.c and the
masker truth table at Source/GB_masker.c:20-27).

Two paths cover every case:

  * dense path — any operand bitmap/full: ``torch.where`` algebra, bitmap
    output.
  * sparse path — all operands sparse/hyper: one union merge of C and T
    (``segment.union_merge``), a mask lookup, and a compaction.
"""

from __future__ import annotations

import torch

from ..core import config as CFG
from ..core import types as T
from ..core.convert import _clone, _reclass
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import BITMAP, FULL, HYPER, INDEX, ROW, SPARSE, Matrix
from ..core.types import cast
from ..kernels import segment as K


def _is_dense(a: Matrix | None) -> bool:
    return a is not None and a.fmt in (BITMAP, FULL)


def mask_bits_dense(mask: Matrix | None, shape, desc: Descriptor, device):
    """Dense bool mask with structure/complement applied."""
    if mask is None:
        m = torch.ones(shape, dtype=torch.bool, device=device)
        return ~m if desc.mask_complement else m
    mv, mp = mask.to_dense_pair()
    m = mp if desc.mask_structure else (mp & (T.bits(mv) != 0))
    return ~m if desc.mask_complement else m


def mask_bits_at_keys(mask: Matrix, keys, veclen: int, orient: str,
                      desc: Descriptor):
    """Mask bool at each (sorted-key) position — the dot3-style mask
    lookup (reference: GB_masker phase1)."""
    return mask_lookup(mask, veclen, orient, desc)(keys)


def mask_lookup(mask: Matrix, veclen: int, orient: str, desc: Descriptor):
    """``mask_bits_at_keys`` for many key arrays: a function of the keys,
    a sparse mask's own sorted keys worked out once."""
    if mask.fmt in (BITMAP, FULL):
        mv, mp = mask.to_dense_pair()

        def bits(keys):
            vec = (keys // veclen).long()
            idx = (keys % veclen).long()
            i, j = (vec, idx) if orient == ROW else (idx, vec)
            m = mp[i, j] if desc.mask_structure else \
                (mp[i, j] & (T.bits(mv)[i, j] != 0))
            return ~m if desc.mask_complement else m
        return bits
    mk, mvals = _keys_of(mask.to_orient(orient))

    def bits(keys):
        found, pos = K.lookup_sorted(mk, keys)
        if desc.mask_structure or mvals.shape[0] == 0:
            m = found
        else:
            m = found & (T.bits(mvals)[pos] != 0)
        return ~m if desc.mask_complement else m
    return bits


def _keys_of(a: Matrix):
    """(sorted int64 keys, expanded values) of a sparse/hyper matrix in its
    own orientation's storage order."""
    a = a.to_format(SPARSE) if a.fmt == HYPER else a
    rows, cols = a._coords()
    vec, idx = (rows, cols) if a.orient == ROW else (cols, rows)
    return K.make_key(vec, idx, a._veclen()), a._vals_expanded()


def writeback(C: Matrix | None, mask: Matrix | None, accum, Tm: Matrix,
              desc: Descriptor = NULL, out_dtype=None, out_class=None):
    """Returns the new C (a fresh Matrix; callers transplant in place);
    span ``masker.writeback``."""
    with CFG.timed("masker.writeback", Tm.device):
        return _writeback(C, mask, accum, Tm, desc, out_dtype, out_class)


def _writeback(C, mask, accum, Tm, desc, out_dtype, out_class):
    klass = out_class or (type(C) if C is not None else type(Tm))
    dt = T.lookup(out_dtype) if out_dtype is not None else (
        C.dtype if C is not None else Tm.dtype)

    no_c = C is None or (C.fmt in (SPARSE, HYPER) and C.nvals == 0)
    if mask is None and not desc.mask_complement and (accum is None or no_c):
        # transplant fast path (reference: GB_transplant_conform)
        CFG.burble("writeback: transplant")
        return _reclass(_cast_matrix(Tm, dt), klass)

    if C is None:
        C = Matrix.new(dt, Tm.nrows, Tm.ncols, SPARSE, Tm.orient,
                       device=Tm.device)

    if _is_dense(C) or _is_dense(Tm) or _is_dense(mask):
        CFG.burble("writeback: dense path")
        return _reclass(_writeback_dense(C, mask, accum, Tm, desc, dt),
                        klass)
    CFG.burble("writeback: sparse merge path")
    return _reclass(_writeback_sparse(C, mask, accum, Tm, desc, dt), klass)


def _cast_matrix(a: Matrix, dt) -> Matrix:
    if a.dtype is dt:
        return a
    return _clone(a, dtype=dt, values=cast(a.values, dt))


def _writeback_dense(C, mask, accum, Tm, desc, dt):
    cv, cp = C.to_dense_pair()
    tv, tp = Tm.to_dense_pair()
    cv = cast(cv, dt)
    tv = cast(tv, dt)
    if accum is None:
        zv, zp = tv, tp
    else:
        acc = cast(accum.fn(cv, tv), dt)
        zv = T.where(cp & tp, acc, T.where(tp, tv, cv))
        zp = cp | tp
    m = mask_bits_dense(mask, C.shape, desc, C.device)
    rv = T.where(m, zv, cv)
    rp = (zp & m) if desc.replace else torch.where(m, zp, cp)
    rv = T.where(rp, rv, torch.zeros((), dtype=dt.torch_dtype,
                                     device=C.device))
    return Matrix((C.nrows, C.ncols), dt, BITMAP, C.orient, values=rv,
                  bitmap=rp)


def _writeback_sparse(C, mask, accum, Tm, desc, dt):
    orient = C.orient
    Tm = Tm.to_orient(orient)
    Tm = Tm.to_format(SPARSE) if Tm.fmt == HYPER else Tm
    Cs = C.to_format(SPARSE) if C.fmt == HYPER else C
    ck, cvals = _keys_of(Cs)
    tk, tvals = _keys_of(Tm)
    ukeys, ucv, utv, c_in, t_in = K.union_merge(
        ck, cast(cvals, dt), tk, cast(tvals, dt))
    nu = ukeys.shape[0]
    dev = C.device
    if accum is None:
        zv = T.where(t_in, utv, ucv)
        z_in = t_in
    else:
        zv = T.where(c_in & t_in, cast(accum.fn(ucv, utv), dt),
                     T.where(t_in, utv, ucv))
        z_in = c_in | t_in
    if mask is None:
        m = torch.full((nu,), not desc.mask_complement, dtype=torch.bool,
                       device=dev)
    else:
        m = mask_bits_at_keys(mask, ukeys, C._veclen(), orient, desc)
    keep = (z_in & m) if desc.replace else (z_in & m) | (c_in & ~m)
    rvals = T.where(m, zv, ucv)
    _, (fk, fv) = K.compact(keep, ukeys, rvals)
    uvec, uidx = K.key_split(fk, C._veclen())
    indptr = K.indptr_from_sorted(uvec, C._nvec_dim(), INDEX)
    return Matrix((C.nrows, C.ncols), dt, SPARSE, orient, indptr=indptr,
                  indices=uidx, values=fv)
