"""GrB_kronecker (counterpart of ``graphblas_tpu.ops.kron``; reference:
Source/GB_kroner.c).

C((iA, iB), (jA, jB)) = op(A(iA, jA), B(iB, jB)), with row iA * p + iB
and column jA * q + jB for B of shape (p, q).  With both operands
row-sorted the products come out in order: output row (iA, iB) is row iA
of A times row iB of B, and its columns ac * q + bc ascend with (ac, bc).
So every product is placed by index arithmetic alone, with no sort (the
JAX package argsorts the nnz(A) * nnz(B) keys).  Coordinates are int64
throughout (m * p or n * q may pass 2^31).
"""

from __future__ import annotations

import torch

from ..core import config as CFG
from ..core import types as T
from ..core.descriptor import NULL, Descriptor
from ..core.matrix import INDEX, ROW, SPARSE, Matrix
from ..core.types import cast
from .masker import writeback
from .transpose import maybe_transpose


def kron(A: Matrix, B: Matrix, op, *, C=None, mask=None, accum=None,
         desc: Descriptor = NULL, out_dtype=None):
    A = maybe_transpose(A, desc.transpose0)
    B = maybe_transpose(B, desc.transpose1)
    zt = T.lookup(out_dtype) if out_dtype else op.out_type(A.dtype, B.dtype)
    As = A.to_format(SPARSE, ROW)
    Bs = B.to_format(SPARSE, ROW)
    nnzA = int(As.indices.shape[0])
    nnzB = int(Bs.indices.shape[0])
    m, n = A.shape
    p, q = B.shape
    out_shape = (m * p, n * q)
    CFG.burble("kron: %d x %d products", nnzA, nnzB)
    if nnzA == 0 or nnzB == 0:
        Tm = Matrix(out_shape, zt, SPARSE, ROW, device=A.device)
        return writeback(C, mask, accum, Tm, desc, out_dtype)
    dev = A.device
    ipa, ipb = As.indptr.long(), Bs.indptr.long()
    dega, degb = torch.diff(ipa), torch.diff(ipb)
    # products per output row (iA, iB), row-major over (iA, iB)
    cnt = (dega[:, None] * degb[None, :]).reshape(-1)
    F = nnzA * nnzB
    indptr = torch.zeros(m * p + 1, dtype=torch.int64, device=dev)
    torch.cumsum(cnt, 0, out=indptr[1:])
    r = torch.repeat_interleave(
        torch.arange(m * p, dtype=torch.int64, device=dev), cnt,
        output_size=F)
    off = torch.arange(F, dtype=torch.int64, device=dev) - indptr[r]
    ia, ib = r // p, r % p
    db = degb[ib]
    ea = ipa[ia] + off // db
    eb = ipb[ib] + off % db
    cols = As.indices.long()[ea] * q + Bs.indices.long()[eb]
    av = T.take(As._vals_expanded(), ea)
    bv = T.take(Bs._vals_expanded(), eb)
    vals = cast(op.fn(av, bv), zt)
    Tm = Matrix(out_shape, zt, SPARSE, ROW, indptr=indptr.to(INDEX),
                indices=cols.to(INDEX), values=vals)
    return writeback(C, mask, accum, Tm, desc, out_dtype)
