"""The GraphBLAS matrix object on torch tensors (counterpart of
``graphblas_tpu.core.matrix``).

Reference: Source/Shared/GB_matrix.h — one struct for Matrix/Vector/
Scalar, 8 storage formats = {hypersparse, sparse, bitmap, full} x {by-row
(CSR), by-col (CSC)}, iso-valued matrices.

A Matrix is a dataclass of tensors (indptr/h/indices/values/bitmap) plus
metadata (shape/format/orientation/iso/type).  Index arrays are int32
(``INDEX``) so they compare one for one with the JAX package.  Every
tensor of a matrix lies on its ``device``.  Constructors take ``device=``;
without it they use the ``device`` option (the card by default, and they
raise where there is none — see ``config.default_device``).  Ops run on
their operands' device.
bitmap/full store values in the logical (nrows, ncols) layout.

Non-blocking mode (reference: GB_matrix.h:313-390, GB_wait.c):
``set_element``/``remove_element`` queue host-side events in ``_pending``
(numpy (rows, cols, value, dup) tuples, bounds checked when queued);
``wait()`` applies them, the last event per entry winning, and rebinds
the matrix to new tensors (caches keyed on the old ones stay valid).
Every public entry point waits first: the ``api`` ops, ``nvals``,
``to_format``, ``coo``, ``to_dense_pair``, ``dup``, ``_replace_from``,
``optimize`` and element access.  In blocking mode (``init("blocking")``)
every event is applied as it is queued.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from . import config as CFG
from . import errors as E
from . import types as T

HYPER = "hyper"
SPARSE = "sparse"
BITMAP = "bitmap"
FULL = "full"
FORMATS = (HYPER, SPARSE, BITMAP, FULL)

ROW = "row"   # CSR-like: vectors are rows (reference default)
COL = "col"   # CSC-like: vectors are columns

INDEX = torch.int32   # index dtype, as the JAX package's np.int32


def _as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """numpy/list/tensor -> tensor on ``device`` (tensors keep their own
    device unless one is given; other arrays go to the default device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device or x.device, dtype=dtype or x.dtype)
    device = CFG.default_device(device)
    arr = np.asarray(x)
    t = torch.from_numpy(np.ascontiguousarray(arr)) if arr.dtype.kind in \
        "biufc" else torch.as_tensor(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


@dataclasses.dataclass(eq=False, repr=False)
class Matrix:
    """GrB_Matrix.  See the module docstring for the storage model."""

    shape: tuple
    dtype: T.Type
    fmt: str = SPARSE
    orient: Optional[str] = None
    iso: bool = False
    indptr: Optional[torch.Tensor] = None
    h: Optional[torch.Tensor] = None
    indices: Optional[torch.Tensor] = None
    values: Optional[torch.Tensor] = None
    bitmap: Optional[torch.Tensor] = None
    name: str = ""
    device: Optional[torch.device] = None
    _nvals_cache: Optional[int] = None
    sparsity_control: Optional[str] = None
    hyper_switch: Optional[float] = None
    bitmap_switch: Optional[float] = None
    _pending: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.orient = self.orient or CFG.GLOBAL.format_default
        if self.fmt not in FORMATS:
            raise E.InvalidValue(f"bad format {self.fmt!r}")
        if self.orient not in (ROW, COL):
            raise E.InvalidValue(f"bad orientation {self.orient!r}")
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        self.dtype = T.lookup(self.dtype)
        self.iso = bool(self.iso)
        if self.device is None:
            held = [t for t in (self.values, self.indptr, self.bitmap)
                    if t is not None]
            self.device = held[0].device if held \
                else CFG.default_device()
        self.device = torch.device(self.device)
        if self.fmt in (SPARSE, HYPER) and self.indptr is None:
            # empty matrix
            nvec = 0 if self.fmt == HYPER else self._nvec_dim()
            self.indptr = torch.zeros(nvec + 1, dtype=INDEX,
                                      device=self.device)
            self.indices = torch.zeros(0, dtype=INDEX, device=self.device)
            self.values = torch.zeros((0,) + self.dtype.shape,
                                      dtype=self.dtype.torch_dtype,
                                      device=self.device)
            if self.fmt == HYPER:
                self.h = torch.zeros(0, dtype=INDEX, device=self.device)

    # -- basic geometry ----------------------------------------------------

    @property
    def nrows(self):
        return self.shape[0]

    @property
    def ncols(self):
        return self.shape[1]

    def _nvec_dim(self) -> int:
        """Number of vectors for the sparse format (rows if ROW)."""
        return self.shape[0] if self.orient == ROW else self.shape[1]

    def _veclen(self) -> int:
        return self.shape[1] if self.orient == ROW else self.shape[0]

    @property
    def nvals(self) -> int:
        """Number of stored entries (GrB_Matrix_nvals); one host sync for
        the bitmap format (a ``host_syncs``)."""
        self.wait()
        if self.fmt in (SPARSE, HYPER):
            return int(self.indices.shape[0])
        if self.fmt == FULL:
            return self.nrows * self.ncols
        if self._nvals_cache is None:
            self._nvals_cache = int(CFG.blocking_copy(self.bitmap.sum(),
                                                      "cpu"))
        return self._nvals_cache

    # -- construction ------------------------------------------------------

    @classmethod
    def new(cls, dtype, nrows, ncols, fmt=SPARSE, orient=None,
            device=None):
        """GrB_Matrix_new: empty matrix on ``device``."""
        device = CFG.default_device(device)
        if fmt in (BITMAP, FULL):
            ty = T.lookup(dtype)
            vals = torch.zeros((nrows, ncols) + ty.shape,
                               dtype=ty.torch_dtype, device=device)
            bm = torch.zeros((nrows, ncols), dtype=torch.bool,
                             device=device) if fmt == BITMAP else None
            return cls((nrows, ncols), dtype, fmt, orient, values=vals,
                       bitmap=bm)
        return cls((nrows, ncols), dtype, fmt, orient, device=device)

    @classmethod
    def from_coo(cls, rows, cols, vals, shape, dtype=None, dup="plus",
                 orient=None, iso=False, device=None):
        """GrB_Matrix_build (reference: Source/GB_builder.c); see
        ops/build.py."""
        from ..ops import build as _build
        return _build.build_matrix(cls, rows, cols, vals, shape, dtype, dup,
                                   orient, iso, device)

    @classmethod
    def from_dense(cls, arr, orient=None, device=None):
        """Full matrix from a dense array (all entries present).  A tensor
        stays on its device unless ``device`` is given; other arrays go to
        ``device`` (default ``config.default_device()``)."""
        arr = _as_tensor(arr, device=device or _dev_of(arr))
        if arr.dim() != 2:
            raise E.InvalidValue("from_dense: need a 2-D array")
        return cls(tuple(arr.shape), T.lookup(arr.dtype), FULL, orient,
                   values=arr)

    @classmethod
    def from_dense_masked(cls, arr, present, orient=None, device=None):
        """Bitmap matrix from a (values, present) pair."""
        dev = device or _dev_of(arr)
        arr = _as_tensor(arr, device=dev)
        present = _as_tensor(present, dtype=torch.bool, device=dev)
        return cls(tuple(arr.shape), T.lookup(arr.dtype), BITMAP, orient,
                   values=arr, bitmap=present)

    @classmethod
    def from_scipy(cls, sp, orient=None, dtype=None, device=None):
        """Construct from a scipy.sparse matrix on ``device``."""
        import scipy.sparse as sps
        device = CFG.default_device(device)
        orient = orient or CFG.GLOBAL.format_default
        want = sps.csr_matrix if orient == ROW else sps.csc_matrix
        m = want(sp)
        m.sort_indices()
        dt = T.lookup(dtype) if dtype is not None else T.lookup(m.dtype)
        return cls(sp.shape, dt, SPARSE, orient,
                   indptr=_as_tensor(m.indptr.astype(np.int32),
                                     device=device),
                   indices=_as_tensor(m.indices.astype(np.int32),
                                      device=device),
                   values=T.from_host(m.data, dt, device))

    @classmethod
    def from_mtx(cls, path, dtype=None, orient=None, device=None):
        """Load a Matrix Market file (the native parser of
        ``utils/native.py``, scipy's ``mmread`` without the library);
        duplicates are summed."""
        from ..utils import native as NV
        rows, cols, vals, shape = NV.read_mtx(str(path))
        return cls.from_coo(rows, cols, vals, shape, dtype=dtype,
                            dup="plus", orient=orient, device=device)

    def to_scipy(self):
        import scipy.sparse as sps
        a = self.to_format(SPARSE)
        klass = sps.csr_matrix if a.orient == ROW else sps.csc_matrix
        return klass((T.host(a._vals_expanded()), T.host(a.indices),
                      T.host(a.indptr)), shape=self.shape)

    def dup(self) -> "Matrix":
        """GrB_Matrix_dup.  Tensors are never written in place, so sharing
        them is safe."""
        from .convert import _clone
        return _clone(self.wait())

    def clear(self) -> None:
        """GrB_Matrix_clear: remove all entries, keep shape and type."""
        fmt = SPARSE if self.fmt == HYPER else self.fmt
        self._replace_from(Matrix.new(self.dtype, self.nrows, self.ncols,
                                      fmt, self.orient, self.device))

    def _replace_from(self, other: "Matrix") -> None:
        """In-place adoption of another matrix's contents (reference:
        GB_transplant_conform); this matrix's own queued events go."""
        other.wait()
        for s in ("shape", "fmt", "orient", "iso", "dtype", "indptr", "h",
                  "indices", "values", "bitmap", "_nvals_cache", "device"):
            setattr(self, s, getattr(other, s))
        self._pending = []

    # -- values access -----------------------------------------------------

    def _vals_expanded(self) -> torch.Tensor:
        """values with iso-compression undone."""
        if not self.iso:
            return self.values
        one = self.values.reshape(self.dtype.shape)
        if self.fmt in (SPARSE, HYPER):
            return one.expand((self.indices.shape[0],) + self.dtype.shape)
        return one.expand(self.shape + self.dtype.shape)

    def iso_value(self) -> torch.Tensor:
        """The one value of an iso matrix (a 0-d tensor; a struct type's
        field shape)."""
        if not self.iso:
            raise E.InvalidValue("matrix is not iso")
        return self.values.reshape(self.dtype.shape)

    # -- dense pair (the universal internal representation) ----------------

    def to_dense_pair(self, fill=None):
        """(values[nrows, ncols], present[nrows, ncols]); absent entries
        hold ``fill`` (default 0)."""
        self.wait()
        ty = self.dtype
        fillv = T.scalar(0 if fill is None else fill, ty, self.device)
        if self.fmt == FULL:
            return self._vals_expanded(), torch.ones(
                self.shape, dtype=torch.bool, device=self.device)
        if self.fmt == BITMAP:
            return (T.where(self.bitmap, self._vals_expanded(), fillv),
                    self.bitmap)
        a = self.to_format(SPARSE) if self.fmt == HYPER else self
        rows, cols = a._coords()
        rows, cols = rows.long(), cols.long()
        dense = fillv.expand(self.shape + ty.shape).clone()
        T.bits(dense)[rows, cols] = T.bits(a._vals_expanded())
        present = torch.zeros(self.shape, dtype=torch.bool,
                              device=self.device)
        present[rows, cols] = True
        return dense, present

    def _coords(self):
        """(row_ids, col_ids) of stored entries (sparse/hyper format), in
        storage order."""
        from ..kernels import segment as K
        nnz = int(self.indices.shape[0])
        if self.fmt == HYPER:
            vec_pos = K.expand_rowids(self.indptr, nnz, self.h.shape[0])
            vec_ids = self.h[vec_pos.long()] if self.h.shape[0] else vec_pos
        else:
            vec_ids = K.expand_rowids(self.indptr, nnz, self._nvec_dim())
        if self.orient == ROW:
            return vec_ids, self.indices
        return self.indices, vec_ids

    def coo(self):
        """(rows, cols, values) tensors — GrB_Matrix_extractTuples."""
        self.wait()
        a = self.to_format(SPARSE) if self.fmt != SPARSE else self
        r, c = a._coords()
        return r, c, a._vals_expanded()

    # -- format conversion (reference: Source/GB_convert_*.c) --------------

    def to_format(self, fmt, orient=None) -> "Matrix":
        self.wait()
        orient = orient or self.orient
        if fmt == self.fmt and orient == self.orient:
            return self
        from . import convert
        return convert.convert(self, fmt, orient)

    def to_orient(self, orient) -> "Matrix":
        return self.to_format(self.fmt, orient)

    # -- @GrB-style indexing and operator sugar (reference: GraphBLAS/@GrB
    #    m-files; logical indexing via gblogassign.c / gblogextract.c) ----

    @staticmethod
    def _is_point(x) -> bool:
        return isinstance(x, (int, np.integer))

    def __getitem__(self, ij):
        """A[i, j] -> the element; A[I, J] with slices / lists -> extract;
        A[M] with a Matrix -> C<M> = A, the mask read by its values (the
        @GrB logical index: entries of M that hold false select
        nothing)."""
        from .. import api
        if isinstance(ij, Matrix):
            from . import ops as OPS
            return api.apply(self, OPS.IDENTITY, mask=ij)
        i, j = ij
        if self._is_point(i) and self._is_point(j):
            return self.extract_element(i, j)
        I = [i] if self._is_point(i) else i
        J = [j] if self._is_point(j) else j
        return api.extract(self, I, J)

    def __setitem__(self, ij, value):
        """A[i, j] = x -> set_element; A[I, J] = x or a Matrix ->
        subassign; A[M] = x -> C<M> = x over all of A, the mask read by
        its values (the reference's headline C(M) = x, gblogassign.c:
        "C(M)=A in 0.8 s vs MATLAB 4-5 days")."""
        from .. import api
        if isinstance(ij, Matrix):
            api.assign(self, value, mask=ij)
            return
        i, j = ij
        if self._is_point(i) and self._is_point(j) and np.isscalar(value):
            self.set_element(i, j, value)
            return
        I = [i] if self._is_point(i) else i
        J = [j] if self._is_point(j) else j
        api.subassign(self, value, I, J)

    def _ewise_or_bind(self, other, op, reverse=False):
        from .. import api
        if isinstance(other, Matrix):
            a, b = (other, self) if reverse else (self, other)
            return api.ewise_add(a, b, op)
        bind = ("first", other) if reverse else ("second", other)
        return api.apply(self, op, bind=bind)

    def __add__(self, other):
        from . import ops as OPS
        return self._ewise_or_bind(other, OPS.PLUS)

    def __radd__(self, other):
        from . import ops as OPS
        return self._ewise_or_bind(other, OPS.PLUS, reverse=True)

    def __sub__(self, other):
        from . import ops as OPS
        return self._ewise_or_bind(other, OPS.MINUS)

    def __rsub__(self, other):
        from . import ops as OPS
        return self._ewise_or_bind(other, OPS.MINUS, reverse=True)

    def __mul__(self, other):
        from .. import api
        from . import ops as OPS
        if isinstance(other, Matrix):
            return api.ewise_mult(self, other, OPS.TIMES)
        return api.apply(self, OPS.TIMES, bind=("second", other))

    def __rmul__(self, other):
        from .. import api
        from . import ops as OPS
        return api.apply(self, OPS.TIMES, bind=("first", other))

    def __truediv__(self, other):
        from .. import api
        from . import ops as OPS
        if isinstance(other, Matrix):
            return api.ewise_mult(self, other, OPS.DIV)
        return api.apply(self, OPS.DIV, bind=("second", other))

    def __matmul__(self, other):
        """A @ B -> mxm, A @ v -> mxv, over PLUS_TIMES."""
        from .. import api
        from .semiring import PLUS_TIMES
        if isinstance(other, Vector):
            return api.mxv(self, other, PLUS_TIMES)
        return api.mxm(self, other, PLUS_TIMES)

    def __neg__(self):
        from .. import api
        from . import ops as OPS
        return api.apply(self, OPS.AINV)

    def __abs__(self):
        from .. import api
        from . import ops as OPS
        return api.apply(self, OPS.ABS)

    def __pow__(self, s):
        from .. import api
        from . import ops as OPS
        return api.apply(self, OPS.POW, bind=("second", s))

    def reduce(self, mon, **kw):
        from .. import api
        return api.reduce(self, mon, **kw)

    def reduce_scalar(self, mon, **kw):
        from .. import api
        return api.reduce_scalar(self, mon, **kw)

    def resize(self, nrows, ncols) -> None:
        """GxB_Matrix_resize, in place."""
        from ..ops.resize import resize as _rs
        self._replace_from(_rs(self, nrows, ncols))

    def reshape(self, nrows, ncols, by_col=True):
        """GxB_Matrix_reshapeDup: a new matrix."""
        from ..ops.resize import reshape as _rh
        return _rh(self, nrows, ncols, by_col)

    # -- transpose / cast ---------------------------------------------------

    @property
    def T(self):
        from ..ops.transpose import logical_transpose
        return logical_transpose(self)

    def astype(self, dtype):
        from .. import api
        from . import ops as OPS
        return api.apply(self, OPS.IDENTITY, out_dtype=dtype)

    def isequal(self, other, rtol=0.0, atol=0.0) -> bool:
        """Same shape, same pattern, same values (within tolerance)."""
        if self.shape != other.shape:
            return False
        av, ap = self.to_dense_pair()
        bv, bp = other.to_dense_pair()
        if bool((ap != bp).any()):
            return False
        if av.dtype != bv.dtype:
            ty = T.upcast_pair(self.dtype, other.dtype)
            av, bv = T.cast(av, ty), T.cast(bv, ty)
        if rtol == 0.0 and atol == 0.0:
            ne = T.carry(av) != T.carry(bv)
            return not bool((ap & ne.reshape(ap.shape + (-1,)).any(-1))
                            .any())
        wide = T.FC64 if av.is_complex() else T.FP64
        av, bv = T.cast(av, wide), T.cast(bv, wide)
        close = (av - bv).abs() <= atol + rtol * bv.abs()
        return bool((close.reshape(ap.shape + (-1,)).all(-1) | ~ap).all())

    # -- pending-tuple machinery (non-blocking mode) -----------------------

    def _add_pending(self, rows, cols, vals, dup):
        if isinstance(vals, torch.Tensor):
            vals = T.host(vals)
        self._pending.append((np.atleast_1d(np.asarray(rows)),
                              np.atleast_1d(np.asarray(cols)), vals, dup))
        self._nvals_cache = None
        if CFG.GLOBAL.blocking:
            self.wait()

    def wait(self) -> "Matrix":
        """GrB_Matrix_wait: apply the queued events (reference:
        Source/GB_wait.c; see ops/build.apply_pending)."""
        if not self._pending:
            return self
        pend, self._pending = self._pending, []
        from ..ops import build as _build
        _build.apply_pending(self, pend)
        return self

    # -- element access (reference: Source/GB_setElement.c, GB_Element.h) --

    def _check_index(self, i, j):
        # bounds-checked when the event is queued, as the reference's
        # GrB_*_setElement does, not at wait()
        if not (0 <= int(i) < self.nrows and 0 <= int(j) < self.ncols):
            raise E.IndexOutOfBounds(
                f"({i},{j}) outside {self.nrows}x{self.ncols}")

    def set_element(self, i, j, value):
        self._check_index(i, j)
        self._add_pending(i, j, value, "second")

    def remove_element(self, i, j):
        self._check_index(i, j)
        self._add_pending(i, j, None, "delete")

    def extract_element(self, i, j):
        """GrB_Matrix_extractElement: raises NoValue if absent."""
        from ..ops import element
        return element.extract_element(self.wait(), i, j)

    def is_stored_element(self, i, j) -> bool:
        from ..ops import element
        return element.is_stored(self.wait(), i, j)

    # -- per-object get/set (reference: GrB_get/GrB_set over matrices) -----

    def get(self, name: str):
        opts = {"format": self.fmt, "orientation": self.orient,
                "nrows": self.nrows, "ncols": self.ncols,
                "dtype": self.dtype.name, "iso": self.iso,
                "name": self.name,
                "sparsity_control": self.sparsity_control or "auto",
                "hyper_switch": self.hyper_switch,
                "bitmap_switch": self.bitmap_switch}
        if name not in opts:
            raise E.InvalidValue(f"unknown option {name!r}")
        return opts[name]

    def set(self, name: str, value) -> None:
        if name == "format":
            self._replace_from(self.to_format(value))
        elif name == "orientation":
            self._replace_from(self.to_orient(value))
        elif name == "name":
            self.name = str(value)
        elif name == "sparsity_control":
            valid = {HYPER, SPARSE, BITMAP, FULL}
            if value != "auto" and \
                    not {c.strip() for c in str(value).split("+")} <= valid:
                raise E.InvalidValue(f"bad sparsity_control {value!r}")
            self.sparsity_control = value
        elif name in ("hyper_switch", "bitmap_switch"):
            setattr(self, name, float(value))
        else:
            raise E.InvalidValue(f"unknown/read-only option {name!r}")

    # -- diagnostics (reference: GB_matvec_check.c) -------------------------

    def check(self) -> None:
        """Validity check: indptr monotone & terminal, indices in range
        and strictly sorted within vectors, bitmap/values shapes
        consistent."""
        self.wait()
        if self.fmt in (SPARSE, HYPER):
            p = self.indptr.long()
            nnz = int(self.indices.shape[0])
            if int(p[0]) != 0 or int(p[-1]) != nnz:
                raise E.InvalidObject("indptr endpoints")
            if bool((p[1:] < p[:-1]).any()):
                raise E.InvalidObject("indptr not monotone")
            if self.values.shape[0] != (1 if self.iso else nnz):
                raise E.InvalidObject("values length")
            idx = self.indices.long()
            if nnz and (int(idx.min()) < 0
                        or int(idx.max()) >= self._veclen()):
                raise E.InvalidObject("indices out of range")
            from ..kernels import segment as K
            vec = K.expand_rowids(self.indptr, nnz, p.shape[0] - 1)
            same = vec[1:] == vec[:-1]
            if bool((same & (idx[1:] <= idx[:-1])).any()):
                raise E.InvalidObject("vector not strictly sorted")
            if self.fmt == HYPER:
                hh = self.h.long()
                if hh.numel() and (bool((hh[1:] <= hh[:-1]).any())
                                   or int(hh.min()) < 0
                                   or int(hh.max()) >= self._nvec_dim()):
                    raise E.InvalidObject("hyperlist invalid")
        if self.fmt == BITMAP and tuple(self.bitmap.shape) != self.shape:
            raise E.InvalidObject("bitmap shape")
        if self.fmt in (BITMAP, FULL) and not self.iso:
            if tuple(self.values.shape) != self.shape + self.dtype.shape:
                raise E.InvalidObject("values shape")

    def fprint(self, level: int = 2, name: str = "", file=None) -> None:
        """GxB_Matrix_fprint analog: the validity check, then a header and
        entries (reference: Source/GB_matvec_check.c).  level: 0 silent
        check, 1 header, 2 + the first 8 entries, 3 all entries."""
        import sys
        out = file or sys.stdout
        self.check()
        if level == 0:
            return
        print(f"{name or self.name or type(self).__name__}: {self!r}",
              file=out)
        if level >= 2:
            r, c, v = (T.host(t) for t in self.coo())
            shown = len(r) if level >= 3 else min(8, len(r))
            for k in range(shown):
                print(f"  ({r[k]},{c[k]})  {v[k]}", file=out)
            if shown < len(r):
                print(f"  ... ({len(r) - shown} more)", file=out)

    def optimize(self, plan_path=None) -> "Matrix":
        """Build (or load) the SpMV plan for this matrix and return the
        CSR-sparse FP32 view whose mxv/vxm calls run through it
        (kernels/spmv_route.py).  ``plan_path``: optional .npz cache in
        the port's plan format — loaded when present and matching this
        matrix, else the freshly built plan is saved there."""
        from ..kernels import spmv_route
        from .convert import _clone
        Ar = self.wait().to_format(SPARSE, ROW)
        if Ar.dtype != T.FP32 or Ar.iso:
            Ar = Ar.astype(T.FP32)
            if Ar.iso:
                Ar = _clone(Ar, values=Ar._vals_expanded().contiguous(),
                            iso=False)
        if spmv_route.plan_for(Ar.indptr, Ar.indices, Ar.values,
                               Ar.shape, build=False) is not None:
            return Ar
        plan = None
        if plan_path and os.path.exists(plan_path):
            plan = spmv_route.load_plan(plan_path)
            if not plan.matches(Ar.indptr, Ar.shape) \
                    or plan.nnz != Ar.nvals:      # stale cache
                plan = None
            else:
                CFG.burble("optimize: loaded plan from %s", plan_path)
        if plan is None:
            plan = spmv_route.build_plan(Ar.indptr, Ar.indices, Ar.values,
                                         Ar.shape)
            if plan_path:
                spmv_route.save_plan(plan, plan_path)
                CFG.burble("optimize: saved plan to %s", plan_path)
        spmv_route.register_plan(Ar.indptr, Ar.indices, Ar.values,
                                 Ar.shape, plan)
        return Ar

    def memory_usage(self) -> int:
        """GxB_Matrix_memoryUsage: bytes of the stored arrays."""
        return sum(a.numel() * a.element_size()
                   for a in (self.indptr, self.h, self.indices, self.values,
                             self.bitmap) if a is not None)

    def __repr__(self):
        nv = "?" if self._pending or (self.fmt == BITMAP
                                      and self._nvals_cache is None) \
            else self.nvals
        return (f"{type(self).__name__}({self.shape[0]}x{self.shape[1]} "
                f"{self.dtype.name} {self.fmt}/{self.orient}"
                f"{' iso' if self.iso else ''} nvals={nv} {self.device})")


def _dev_of(x):
    return x.device if isinstance(x, torch.Tensor) \
        else CFG.default_device()


@dataclasses.dataclass(eq=False, repr=False, init=False)
class Vector(Matrix):
    """GrB_Vector == n-by-1 matrix stored by column (reference:
    Source/GB_vector.h)."""

    def __init__(self, n_or_shape, dtype, fmt=SPARSE, **kw):
        if isinstance(n_or_shape, tuple):
            shape = n_or_shape
            if shape[1] != 1:
                raise E.DimensionMismatch(f"vector shape {shape}")
        else:
            shape = (int(n_or_shape), 1)
        kw.pop("orient", None)
        Matrix.__init__(self, shape, dtype, fmt, COL, **kw)

    @property
    def size(self):
        return self.shape[0]

    @classmethod
    def new(cls, dtype, n, fmt=SPARSE, orient=None, device=None):
        device = CFG.default_device(device)
        if fmt in (BITMAP, FULL):
            ty = T.lookup(dtype)
            vals = torch.zeros((n, 1), dtype=ty.torch_dtype, device=device)
            bm = torch.zeros((n, 1), dtype=torch.bool, device=device) \
                if fmt == BITMAP else None
            return cls(n, dtype, fmt, values=vals, bitmap=bm)
        return cls(n, dtype, fmt, device=device)

    @classmethod
    def from_coo(cls, idx, vals, n, dtype=None, dup="plus", iso=False,
                 device=None):
        from ..ops import build as _build
        idx = np.atleast_1d(np.asarray(idx))
        return _build.build_matrix(cls, idx, np.zeros_like(idx), vals,
                                   (n, 1), dtype, dup, COL, iso, device)

    @classmethod
    def from_dense(cls, arr, orient=None, device=None):
        arr = _as_tensor(arr, device=device or _dev_of(arr))
        if arr.dim() == 1:
            arr = arr[:, None]
        return cls(tuple(arr.shape), T.lookup(arr.dtype), FULL, values=arr)

    @classmethod
    def from_dense_masked(cls, arr, present, orient=None, device=None):
        dev = device or _dev_of(arr)
        arr = _as_tensor(arr, device=dev)
        present = _as_tensor(present, dtype=torch.bool, device=dev)
        if arr.dim() == 1:
            arr, present = arr[:, None], present[:, None]
        return cls(tuple(arr.shape), T.lookup(arr.dtype), BITMAP,
                   values=arr, bitmap=present)

    def to_dense_1d(self, fill=None):
        v, p = self.to_dense_pair(fill)
        return v[:, 0], p[:, 0]

    def set_element(self, i, value, _v=None):
        if _v is not None:            # matrix-style (i, j, value)
            super().set_element(i, value, _v)
        else:
            super().set_element(i, 0, value)

    def remove_element(self, i, j=None):
        super().remove_element(i, 0 if j is None else j)

    def extract_element(self, i, j=None):
        return super().extract_element(i, 0 if j is None else j)

    def is_stored_element(self, i, j=None) -> bool:
        return super().is_stored_element(i, 0 if j is None else j)

    def __getitem__(self, i):
        if isinstance(i, tuple):
            return super().extract_element(*i)
        return self.extract_element(i)

    def __setitem__(self, i, value):
        if isinstance(i, tuple):
            super().set_element(i[0], i[1], value)
        else:
            self.set_element(i, value)


@dataclasses.dataclass(eq=False, repr=False, init=False)
class Scalar(Matrix):
    """GrB_Scalar == 1-by-1 matrix (reference: Source/GB_Scalar*)."""

    def __init__(self, dtype, fmt=SPARSE, **kw):
        kw.pop("orient", None)
        Matrix.__init__(self, (1, 1), dtype, fmt, COL, **kw)

    @classmethod
    def from_value(cls, value, dtype=None, device=None):
        from ..ops import build as _build
        return _build.build_matrix(cls, [0], [0], [value], (1, 1), dtype,
                                   "second", COL, False, device)

    @property
    def is_empty(self) -> bool:
        return self.nvals == 0

    def value(self):
        if self.nvals == 0:
            raise E.NoValue("scalar is empty")
        return self.coo()[2][0].item()
