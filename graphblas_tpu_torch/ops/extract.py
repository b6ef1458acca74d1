"""GrB_extract: C<M> = accum(C, A(I,J)) (counterpart of
``graphblas_tpu.ops.extract``; reference: Source/GB_subref.c,
GB_extract.c).

The reference's 12 fine-task subref methods collapse to a vectorized
renumber + compact + sort.  Three paths:

  * BITMAP/FULL A: a dense gather, BITMAP output;
  * unique I and J: renumber every entry through the row/column maps,
    then either one sentinel-key sort of all entries (dropped ones sort
    last) when a quarter or more survive, or compact first and sort the
    survivors;
  * repeated indices: A's vectors are gathered by their index list
    through ``indptr``, and each gathered entry is emitted once for every
    time its index occurs in the other list (an inverse map with
    multiplicity).  The JAX package turns a sparse A into a dense pair
    here instead (2^40 slots at n = 2^20); the result is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import (BITMAP, FULL, HYPER, INDEX, ROW, SPARSE, Matrix,
                           Vector)
from ..kernels import segment as K
from .masker import writeback
from .transpose import maybe_transpose

SENTINEL = 1 << 62


def normalize_index(I, n: int) -> np.ndarray:
    """Resolve GrB_ALL (None) / a slice / a range / an array (numpy, list
    or tensor) to a host int64 index array, bounds checked."""
    if I is None:
        return np.arange(n, dtype=np.int64)
    if isinstance(I, slice):
        return np.arange(*I.indices(n), dtype=np.int64)
    if isinstance(I, range):
        return np.asarray(list(I), dtype=np.int64)
    if isinstance(I, torch.Tensor):
        I = I.cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(I, dtype=np.int64).reshape(-1))
    if arr.size and (arr.min() < 0 or arr.max() >= n):
        raise E.IndexOutOfBounds(f"index out of range [0,{n})")
    return arr


def extract(A: Matrix, I=None, J=None, *, C=None, mask=None, accum=None,
            desc: Descriptor = NULL, out_dtype=None):
    A = maybe_transpose(A, desc.transpose0)
    Iv = normalize_index(I, A.nrows)
    Jv = normalize_index(J, A.ncols)
    Tm = extract_pattern(A, Iv, Jv)
    return writeback(C, mask, accum, Tm, desc, out_dtype,
                     out_class=Vector if isinstance(A, Vector) else None)


def _has_repeats(v: np.ndarray) -> bool:
    if v.size < 2:
        return False
    if (v[1:] > v[:-1]).all():
        return False
    s = np.sort(v)
    return bool((s[1:] == s[:-1]).any())


def extract_pattern(A: Matrix, Iv: np.ndarray, Jv: np.ndarray) -> Matrix:
    """A(I,J) with renumbered indices (no accum/mask)."""
    ni, nj = len(Iv), len(Jv)
    dev = A.device
    if A.fmt in (BITMAP, FULL):
        CFG.burble("extract: dense gather path")
        v, p = A.to_dense_pair()
        ii = torch.from_numpy(Iv).to(dev)[:, None]
        jj = torch.from_numpy(Jv).to(dev)[None, :]
        return Matrix((ni, nj), A.dtype, BITMAP, A.orient,
                      values=T.take(v, (ii, jj)), bitmap=p[ii, jj])
    S = A.to_format(SPARSE) if A.fmt == HYPER else A
    by_row = S.orient == ROW
    Pv, Pi = (Iv, Jv) if by_row else (Jv, Iv)
    nvec, veclen = len(Pv), len(Pi)
    if _has_repeats(Iv) or _has_repeats(Jv):
        CFG.burble("extract: sparse repeat path")
        return _extract_repeat(S, Pv, Pi, (ni, nj))
    CFG.burble("extract: sparse renumber path")
    nnz = int(S.indices.shape[0])
    vals = S._vals_expanded()
    rows, cols = S._coords()
    nr = _new_index(Iv, A.nrows, dev)[rows.long()]
    nc = _new_index(Jv, A.ncols, dev)[cols.long()]
    keep = (nr >= 0) & (nc >= 0)
    cnt = int(keep.sum())
    if cnt == 0:
        return Matrix((ni, nj), A.dtype, SPARSE, S.orient,
                      indptr=torch.zeros(nvec + 1, dtype=INDEX, device=dev),
                      indices=torch.zeros(0, dtype=INDEX, device=dev),
                      values=vals[:0])
    vec, idx = (nr, nc) if by_row else (nc, nr)
    if cnt * 4 >= nnz:
        # one sentinel-key sort of every entry: dropped ones sort last
        keys = torch.where(keep, vec * veclen + idx,
                           torch.full_like(vec, SENTINEL))
        skeys, order = torch.sort(keys, stable=True)
        skeys, order = skeys[:cnt], order[:cnt]
        svals = T.take(vals, order)
    else:
        # few survivors: compact first, then sort them
        _, (kv, ki, kx) = K.compact(keep, vec, idx, vals)
        skeys, order = torch.sort(kv * veclen + ki, stable=True)
        svals = T.take(kx, order)
    svec, sidx = K.key_split(skeys, veclen)
    indptr = K.indptr_from_sorted(svec, nvec, INDEX)
    return Matrix((ni, nj), A.dtype, SPARSE, S.orient, indptr=indptr,
                  indices=sidx, values=svals)


def _new_index(v: np.ndarray, n: int, dev) -> torch.Tensor:
    """The map old index -> position in ``v`` (-1 where absent), built on
    the device from ``v`` (unique)."""
    m = torch.full((n,), -1, dtype=torch.int64, device=dev)
    m[torch.from_numpy(v).to(dev)] = torch.arange(len(v), device=dev)
    return m


def _extract_repeat(S: Matrix, Pv: np.ndarray, Pi: np.ndarray,
                    shape) -> Matrix:
    """A(I,J) where I or J repeat an index, on the sparse pattern: ``Pv``
    selects the stored vectors (rows of a ROW matrix), ``Pi`` the indices
    within them."""
    dev = S.device
    nvec, veclen = len(Pv), len(Pi)
    ar = lambda k: torch.arange(k, dtype=torch.int64, device=dev)  # noqa
    ip = S.indptr.long()
    pv = torch.from_numpy(Pv).to(dev)
    start = ip[pv]
    cnt = ip[pv + 1] - start
    n1 = int(cnt.sum())
    # the gathered vectors' entries, output vector by output vector
    o = torch.repeat_interleave(ar(nvec), cnt, output_size=n1)
    first = torch.cumsum(cnt, 0) - cnt
    src = start[o] + (ar(n1) - first[o])
    c = S.indices[src].long()
    # each entry once for every occurrence of its index in Pi: Pi's
    # positions grouped by index (opos), each index's group at cs[c]
    pi = torch.from_numpy(Pi).to(dev)
    opos = torch.argsort(pi, stable=True)
    cs = torch.zeros(S._veclen() + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(pi, minlength=S._veclen()), 0, out=cs[1:])
    mult = cs[c + 1] - cs[c]
    n2 = int(mult.sum())
    e = torch.repeat_interleave(ar(n1), mult, output_size=n2)
    firstm = torch.cumsum(mult, 0) - mult
    slot = cs[c[e]] + (ar(n2) - firstm[e])
    newidx = opos[slot]
    newvec = o[e]
    src = src[e]
    if not (Pi[1:] >= Pi[:-1]).all():
        # Pi out of order: sort each vector's entries by their new index
        _, order = torch.sort(newvec * veclen + newidx, stable=True)
        newvec, newidx, src = newvec[order], newidx[order], src[order]
    indptr = K.indptr_from_sorted(newvec, nvec, INDEX)
    return Matrix(shape, S.dtype, SPARSE, S.orient, indptr=indptr,
                  indices=newidx.to(INDEX),
                  values=T.take(S._vals_expanded(), src))
