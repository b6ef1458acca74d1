"""State carried across from the JAX package.

``matrix_from_arrays`` rebuilds a port ``Matrix`` from the arrays of a
``graphblas_tpu`` Matrix, handed over as numpy arrays (nothing here takes
a JAX object), values of every type (unsigned and complex included, and
struct types with their field dims) and its pending queue: a list of
numpy (rows, cols, value, dup) tuples, dup "second" for set_element and
"delete" (value None) for remove_element.  ``vector_from_arrays`` and
``scalar_from_arrays`` do the same for Vectors and Scalars.
The tests build every port operand this way from the JAX operand, so both
packages see the same storage and the same queued events.

JAX route plans (``spmv_route.save_plan``) are a TPU layout;
``kernels.spmv_route.load_plan`` refuses them.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import config as CFG
from .core import types as T
from .core.convert import _reclass
from .core.matrix import Matrix, Scalar, Vector


def _t(a, device, dtype=None):
    if a is None:
        return None
    arr = np.ascontiguousarray(np.asarray(a))
    if dtype is not None:
        arr = arr.astype(dtype)
    return torch.from_numpy(arr.copy()).to(device)


def _pending(queue):
    return [(np.array(r, np.int64).reshape(-1),
             np.array(c, np.int64).reshape(-1),
             None if v is None else np.array(v), dup)
            for r, c, v, dup in queue or ()]


def _type(dtype_name, values, field_shape):
    if field_shape:
        return T.struct_type(dtype_name, np.asarray(values).dtype,
                             field_shape)
    return T.lookup(dtype_name)


def matrix_from_arrays(shape, dtype_name, fmt, orient, indptr, h, indices,
                       values, bitmap, iso, device=None,
                       pending=None, field_shape=()) -> Matrix:
    """A port Matrix from a JAX Matrix's fields: ``dtype_name`` is its
    ``dtype.name`` (e.g. "GrB_FP32"), index arrays become int32,
    ``pending`` its queue of events (copied).  A struct type gives its
    ``field_shape`` (its ``dtype.shape``), and its fields' dtype is the
    values'.  ``device`` defaults to ``config.default_device()``."""
    ty = _type(dtype_name, values, field_shape)
    device = CFG.default_device(device)
    M = Matrix(tuple(shape), ty, fmt, orient, iso=bool(iso),
               indptr=_t(indptr, device, np.int32),
               h=_t(h, device, np.int32),
               indices=_t(indices, device, np.int32),
               values=None if values is None else T.from_host(
                   values, ty, device),
               bitmap=_t(bitmap, device, np.bool_),
               device=device)
    M._pending = _pending(pending)
    return M


def vector_from_arrays(n, dtype_name, fmt, indptr, h, indices, values,
                       bitmap, iso, device=None, pending=None,
                       field_shape=()) -> Vector:
    """A port Vector from a JAX Vector's fields (an n-by-1 matrix stored
    by column)."""
    return _reclass(matrix_from_arrays((n, 1), dtype_name, fmt, "col",
                                       indptr, h, indices, values, bitmap,
                                       iso, device, pending, field_shape),
                    Vector)


def scalar_from_arrays(dtype_name, fmt, indptr, h, indices, values, bitmap,
                       iso, device=None, pending=None,
                       field_shape=()) -> Scalar:
    """A port Scalar from a JAX Scalar's fields (a 1-by-1 matrix stored
    by column)."""
    return _reclass(matrix_from_arrays((1, 1), dtype_name, fmt, "col",
                                       indptr, h, indices, values, bitmap,
                                       iso, device, pending, field_shape),
                    Scalar)

