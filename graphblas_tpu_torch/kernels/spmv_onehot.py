"""Plus-times fp32 SpMV with no plan: the counterpart of
``graphblas_tpu.kernels.spmv_onehot.spmv``.

Replaces the TPU kernel graphblas_tpu/kernels/spmv_onehot.py
(``_kernel`` through ``_run_inner``), which routes the x-gather and the
y-scatter through the MXU as one-hot matmuls with bf16 hi/lo splits
(relative error ~2^-16) and needs x and y to fit VMEM (n <= 3*2^19).
Here the CUDA kernel ``spmv_rowwarp_f32`` (``csrc/spmv.cu``) streams the
CSR arrays from device memory with one warp per row and a warp-shuffle
sum: full fp32 products and fp32 accumulation, any size, no
preprocessing.  It is bound by device-memory bytes (~12 B per nonzero
plus the x gather); coalesced index/value loads and x held in L2 are what
the design does about that.

``spmv`` launches the kernel for CUDA tensors and runs ``spmv_plain``, the
plain torch version, for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _cuda
from . import segment as K

# launches of the CUDA kernel (CPU calls run the plain version, uncounted)
launches = 0

# accumulation dtype of the plain versions' sums
ACC = {torch.float32: torch.float64}


def spmv_plain(indptr, indices, values, x, m: int) -> torch.Tensor:
    """Plain torch version: gather, multiply, ``index_add_`` by row.  fp32
    products are summed in fp64 (``ACC``), so a row of 10^5 nonzeros
    stays within the fp32 kernel's error class of the exact sum."""
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
    _cuda.spmv_rowwarp_f32(indptr, indices, values, x, y, m)
    launches += 1
    return y
