"""Plus-times fp32 SpMV with no plan: the counterpart of
``graphblas_tpu.kernels.spmv_onehot.spmv``.

Replaces the TPU kernel graphblas_tpu/kernels/spmv_onehot.py
(``_kernel`` through ``_run_inner``), which routes the x-gather and the
y-scatter through the MXU as one-hot matmuls with bf16 hi/lo splits
(relative error ~2^-16) and needs x and y to fit VMEM (n <= 3*2^19).
Here the CUDA kernel ``spmv_merge_f32`` (``csrc/spmv.cu``) runs a merge
path over the raw CSR arrays, with no preprocessing: the m + nnz steps of
the CSR walk (row ends and nonzeros) are cut into equal tiles, one per
thread block, each finding its start by a warp search of indptr, so a
power-law hub row spreads over many blocks instead of one warp.  Full
fp32 products and fp32 sums, any size.  Its compulsory traffic is 8 B of
device memory per nonzero, but what binds it is the x gather: one random
32-byte L2 request per nonzero.  16-byte loads of the tile's indices and
values and every x gather of a thread in flight at once are what the
design does about that.
The rows cut between tiles leave one carry per tile, which a second
kernel adds to their rows in tile order: no atomics, so the result is
bitwise repeatable.

``spmv`` launches the kernels for CUDA tensors and runs ``spmv_plain``,
the plain torch version, for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import segment as K

# launches of the CUDA kernel (CPU calls run the plain version, uncounted)
launches = 0

# accumulation dtype of the plain versions' sums
ACC = {torch.float32: torch.float64, torch.bfloat16: torch.float32}


def spmv_plain(indptr, indices, values, x, m: int) -> torch.Tensor:
    """Plain torch version: gather, multiply, ``index_add_`` by row.  fp32
    products are summed in fp64 (``ACC``), so a row of 10^5 nonzeros
    stays within the fp32 kernel's error class of the exact sum; bf16
    ones in fp32."""
    nnz = int(indices.shape[0])
    rows = K.expand_rowids(indptr, nnz, m)
    acc = ACC.get(values.dtype, values.dtype)
    y = torch.zeros(m, dtype=acc, device=values.device)
    return y.index_add_(0, rows, (values * x[indices]).to(acc)) \
        .to(values.dtype)


def spmv(indptr, indices, values, x, m: int) -> torch.Tensor:
    """y = A @ x, plus-times fp32, over CSR arrays (indptr/indices int32,
    values and x float32)."""
    global launches
    if not values.is_cuda:
        return spmv_plain(indptr, indices, values, x, m)
    dev = values.device
    nnz = int(indices.shape[0])
    _cuda.require(indptr, "indptr", torch.int32, dev, m + 1)
    _cuda.require(indices, "indices", torch.int32, dev)
    _cuda.require(values, "values", torch.float32, dev, nnz)
    _cuda.require(x, "x", torch.float32, dev)
    y = torch.empty(m, dtype=torch.float32, device=dev)
    if m + nnz:
        _cuda.spmv_merge_f32(indptr, indices, values, x, y)
        launches += 1
    return y
