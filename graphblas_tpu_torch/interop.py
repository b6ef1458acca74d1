"""State carried across from the JAX package.

``matrix_from_arrays`` rebuilds a port ``Matrix`` from the arrays of a
``graphblas_tpu`` Matrix, handed over as numpy arrays (nothing here takes
a JAX object).  The tests build every port operand this way from the JAX
operand, so both packages see the same storage.

JAX route plans (``spmv_route.save_plan``) are a TPU layout;
``kernels.spmv_route.load_plan`` refuses them.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import config as CFG
from .core import types as T
from .core.convert import _reclass
from .core.matrix import Matrix, Vector


def _t(a, device, dtype=None):
    if a is None:
        return None
    arr = np.ascontiguousarray(np.asarray(a))
    if dtype is not None:
        arr = arr.astype(dtype)
    return torch.from_numpy(arr.copy()).to(device)


def matrix_from_arrays(shape, dtype_name, fmt, orient, indptr, h, indices,
                       values, bitmap, iso, device=None) -> Matrix:
    """A port Matrix from a JAX Matrix's fields: ``dtype_name`` is its
    ``dtype.name`` (e.g. "GrB_FP32"), index arrays become int32.
    ``device`` defaults to ``config.default_device()``."""
    ty = T.lookup(dtype_name)
    device = CFG.default_device(device)
    return Matrix(tuple(shape), ty, fmt, orient, iso=bool(iso),
                  indptr=_t(indptr, device, np.int32),
                  h=_t(h, device, np.int32),
                  indices=_t(indices, device, np.int32),
                  values=_t(values, device, ty.np_dtype),
                  bitmap=_t(bitmap, device, np.bool_),
                  device=device)


def vector_from_arrays(n, dtype_name, fmt, indptr, h, indices, values,
                       bitmap, iso, device=None) -> Vector:
    """A port Vector from a JAX Vector's fields (an n-by-1 matrix stored
    by column)."""
    return _reclass(matrix_from_arrays((n, 1), dtype_name, fmt, "col",
                                       indptr, h, indices, values, bitmap,
                                       iso, device), Vector)

