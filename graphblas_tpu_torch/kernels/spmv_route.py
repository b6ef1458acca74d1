"""Planned SpMV over any {min, max, plus} x {times, plus, first, second,
pair} semiring: the counterpart of ``graphblas_tpu.kernels.spmv_route``.

Replaces three TPU kernels of graphblas_tpu/kernels/spmv_route.py:

  * ``spmv_route``         (plus-times fp32; Benes/Clos route + exact
                            row-local cumsum reduce),
  * ``spmv_route_monoid``  (min/max/plus with five multiplies; segmented
                            scan reduce, empty rows take the identity),
  * ``spmv_route_ds``      (fp64 carried as double-single f32 pairs).

The TPU plan is a static permutation because the TensorCore has no
gather.  Hopper gathers natively and has fp64 units, so the port's plan
is only what balances the work: the merge-path tiling of the CSR walk.
The walk merges the m row ends with the nnz nonzeros (m + nnz steps); tile
b is steps [b * tile, (b + 1) * tile), one thread block, and the plan
holds the row each tile starts in (``tile_row``), so the kernel searches
nothing.  Every block has the same work at any row-length skew.  A row cut
between tiles leaves one carry per cut, which a second kernel adds to its
row in tile order: no atomics, so the result is bitwise repeatable.  One
CUDA template, ``spmv_merge_planned<T, ADD, MUL>`` in ``csrc/spmv.cu``,
serves all three entry points (16 instantiations).  Its compulsory
traffic is 8 B of device memory per nonzero (12 B in fp64), but what
binds it is the x gather: one random 32-byte L2 request per nonzero.
16-byte loads of the tile's indices and values and every x gather of a
thread in flight at once are what the design does about that.

Each entry point launches the kernels for CUDA tensors and runs the plain
torch version, which walks the same tiles, for CPU tensors.  So does the
plan's build: on a card its tiling is one more kernel of ``csrc/spmv.cu``
(``spmv_partition``, K2's path search a tile boundary), and the host
waits for nothing.

Plans are kept with the arrays they read (``plan_for``, one cache for
the op layer and the algorithms), and save/load to an ``.npz`` of the
port's own format, matched by a digest of the indptr that only saving
and matching compute.  Plans written by the JAX package
(a TPU route layout) and by earlier versions of the port are refused.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import os

import numpy as np
import torch

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..utils.tensor_cache import TensorCache
from . import _cuda
from .spmv_onehot import ACC

PLAN_FORMAT = "graphblas_tpu_torch.spmv_plan.v2"

MONOID_IDENTITY = {"plus": 0.0, "min": math.inf, "max": -math.inf}
MULTIPLIES = ("times", "plus", "first", "second", "pair")

# launches of the CUDA kernels per entry point, and of the plan's tiling
# (``spmv_partition``; CPU calls are uncounted)
launches = {"spmv_route": 0, "spmv_route_monoid": 0, "spmv_route_ds": 0,
            "spmv_partition": 0}


def _digest(indptr) -> str:
    """sha256 of indptr as int64, which a saved plan is matched by.
    Spans ``spmv_plan.fetch`` (indptr to the host as int64; a device
    array waits for the work queued before it) and ``.digest``."""
    with CFG.timed("spmv_plan.fetch"):
        if isinstance(indptr, torch.Tensor):
            indptr = CFG.blocking_copy(indptr.detach(), "cpu").numpy()
        ip = np.ascontiguousarray(indptr, np.int64)
    with CFG.timed("spmv_plan.digest"):
        return hashlib.sha256(ip.tobytes()).hexdigest()


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@dataclasses.dataclass(eq=False)
class SpmvRoutePlan:
    """Merge-path tiling of one CSR matrix, plus (when bound) its arrays.

    With tile = ``_cuda.SPMV_TILE``, tile b covers steps [b * tile,
    min((b + 1) * tile, m + nnz)) of the walk; it starts after tile_row[b]
    row ends and b * tile - tile_row[b] nonzeros, and ends the rows
    [tile_row[b], tile_row[b + 1]).  ``indptr`` is the array the plan was
    built from or bound to (a build from numpy keeps it too, unbound);
    ``digest`` its sha256 once ``indptr_digest`` has been read."""

    m: int
    n: int
    nnz: int
    tile_row: torch.Tensor        # (tiles + 1,) int32, tile_row[-1] = m
    digest: str | None = None
    indptr: torch.Tensor | None = None
    indices: torch.Tensor | None = None
    values: torch.Tensor | None = None

    @property
    def indptr_digest(self) -> str:
        """sha256 of the tiled indptr as int64, computed from ``indptr``
        on first need and kept: only saving and matching plans read it."""
        if self.digest is None:
            if self.indptr is None:
                raise E.InvalidValue("route plan has no digest and no "
                                     "indptr to take one from")
            self.digest = _digest(self.indptr)
        return self.digest

    @property
    def ntiles(self) -> int:
        return int(self.tile_row.numel()) - 1

    @property
    def device(self) -> torch.device:
        return self.tile_row.device

    def matches(self, indptr, shape) -> bool:
        """True when this plan tiles a matrix with this indptr: the array
        it was built from or bound to, or one with its digest."""
        return (tuple(shape) == (self.m, self.n)
                and int(indptr.shape[0]) == self.m + 1
                and (indptr is self.indptr
                     or _digest(indptr) == self.indptr_digest))

    def bind(self, indptr, indices, values) -> "SpmvRoutePlan":
        """The plan attached to a matrix's CSR arrays (moved to their
        device)."""
        if not self.matches(indptr, (self.m, self.n)) \
                or int(indices.shape[0]) != self.nnz \
                or int(values.shape[0]) != self.nnz:
            raise E.InvalidValue("route plan does not match this matrix")
        return dataclasses.replace(
            self, tile_row=self.tile_row.to(values.device), indptr=indptr,
            indices=indices, values=values)


def _tile_rows(indptr) -> np.ndarray:
    """The row each merge-path tile starts in, and m last: after d steps
    the walk has ended the rows whose end step (indptr[r + 1] + r) comes
    before d.  The plain version of ``_cuda.spmv_partition``."""
    ip = np.ascontiguousarray(indptr, np.int64)
    m = ip.size - 1
    ends = ip[1:] + np.arange(m)
    starts = np.arange(0, m + int(ip[-1]), _cuda.SPMV_TILE)
    return np.append(np.searchsorted(ends, starts), m).astype(np.int32)


@CFG.timed("spmv_plan.build")
def build_plan(indptr, indices, values, shape) -> SpmvRoutePlan:
    """Build the plan for a CSR matrix on indptr's device, bound to the
    arrays (unbound for numpy).  On a card the tiling is one
    ``spmv_partition`` launch over nnz = ``indices.numel()`` (the kernels
    take no other): nothing is read back to the host, and the kernel
    holds indptr[m] to nnz by a device-side assert, which surfaces at the
    next sync as torch's own do.  Elsewhere it is
    ``_tile_rows`` over indptr's numpy view.  No digest is taken
    (``indptr_digest``).  Span ``spmv_plan.build`` around ``.tile``;
    counter ``spmv_plan.builds``."""
    CFG.count("spmv_plan.builds")
    m, n = int(shape[0]), int(shape[1])
    if isinstance(indptr, torch.Tensor) and indptr.is_cuda:
        dev = indptr.device
        nnz = int(indices.numel())
        _cuda.require(indptr, "indptr", torch.int32, dev, m + 1)
        tile_row = torch.empty(_cuda.spmv_tiles(m, nnz) + 1,
                               dtype=torch.int32, device=dev)
        with CFG.timed("spmv_plan.tile", dev):
            _cuda.spmv_partition(indptr, tile_row, nnz)
        launches["spmv_partition"] += 1
    else:
        ip = indptr.detach().numpy() if isinstance(indptr, torch.Tensor) \
            else np.asarray(indptr)
        nnz = int(ip[-1])
        with CFG.timed("spmv_plan.tile"):
            tile_row = torch.from_numpy(_tile_rows(ip))
    plan = SpmvRoutePlan(m=m, n=n, nnz=nnz, tile_row=tile_row, indptr=indptr)
    CFG.burble("route plan: m=%d nnz=%d tiles=%d", m, nnz, plan.ntiles)
    if isinstance(values, torch.Tensor):
        plan.indices, plan.values = indices, values
    return plan


# ---------------------------------------------------------------------------
# plan cache + serialization
# ---------------------------------------------------------------------------

# the plans of live matrices (utils/tensor_cache.py): an entry holds the
# tiling, its arrays unset, and the values the plan made, if any
_plans = TensorCache(16)


def _made_values(kind, indices, values):
    """The values a plan of ``kind`` runs on: ``values`` ("own"), fp32
    ones ("pattern": plus-times is then exact for the pattern semirings)
    or ``values`` in fp32, one value standing for all where it holds one
    (an iso matrix; "fp32")."""
    if kind == "own":
        return values
    if kind == "pattern":
        return torch.ones(indices.shape[0], dtype=torch.float32,
                          device=indices.device)
    v = T.cast(values, T.FP32)
    return (v.reshape(()).expand(indices.shape[0]) if v.numel() == 1
            else v).contiguous()


def _keys(indptr, indices, values, kind):
    return [indptr, indices] + ([] if kind == "pattern" else [values])


def plan_for(indptr, indices, values, shape, build=True, kind="own"):
    """The plan kept for a matrix's arrays (and ``kind``, the values its
    kernel runs on: ``_made_values``), bound to them: no digest, no host
    sync.  With ``build=False`` only an already-kept plan (callers opt in
    through Matrix.optimize() or the algorithms' ``optimize=True``).  A
    build reuses the tiling kept for the same indptr and indices under
    other values (the fp64 copy of an fp32 matrix's values, say).  An
    entry goes with its arrays, and an in-place write to them or to the
    values it made voids it."""
    CFG.count("spmv_plan.lookups")
    ent = _plans.get(_keys(indptr, indices, values, kind),
                     (tuple(shape), kind))
    if ent is not None:
        tiling, made = ent
        return dataclasses.replace(tiling, indptr=indptr, indices=indices,
                                   values=values if made is None else made)
    if not build:
        return None
    made = _made_values(kind, indices, values)
    plan = _plans.get([indptr, indices], (tuple(shape),))
    plan = build_plan(indptr, indices, made, shape) if plan is None else \
        dataclasses.replace(plan, indptr=indptr, indices=indices, values=made)
    return register_plan(indptr, indices, values, shape, plan, kind, made)


def register_plan(indptr, indices, values, shape, plan, kind="own",
                  made=None):
    """Keep a (loaded or built) plan for a matrix's arrays; returns it
    bound to them (to ``made``, the values a plan of another ``kind``
    runs on, where given)."""
    made = values if made is None else made
    if plan.values is not made or plan.indices is not indices:
        plan = plan.bind(indptr, indices, made)
    tiling = dataclasses.replace(plan, indptr=None, indices=None, values=None)
    _plans.put([indptr, indices], (tuple(shape),), tiling)
    own = made is values
    _plans.put(_keys(indptr, indices, values, kind), (tuple(shape), kind),
               (tiling, None if own else made), held=() if own else (made,))
    return plan


def save_plan(plan: SpmvRoutePlan, path) -> None:
    """Write the tiling (not the matrix) to ``path`` as an .npz in the
    port's format, under exactly that name."""
    with open(path, "wb") as f:
        np.savez(f, format=np.array(PLAN_FORMAT),
                 shape=np.array([plan.m, plan.n, plan.nnz,
                                 _cuda.SPMV_TILE], np.int64),
                 tile_row=_host(plan.tile_row),
                 indptr_digest=np.array(plan.indptr_digest))


def load_plan(path) -> SpmvRoutePlan:
    """Read a plan written by ``save_plan`` (unbound, on the CPU; bind it
    with ``register_plan``).  A JAX route plan is a TPU layout and is
    refused; so is a plan of an earlier port format (v1: split sub-rows
    in row blocks) or of another tile size."""
    jax_msg = (f"{path} is a graphblas_tpu (JAX) route plan, a TPU layout "
               "the port cannot run; build the port's plan with "
               "Matrix.optimize(plan_path=...) or spmv_route.save_plan")
    if os.path.isdir(path):
        raise E.InvalidValue(jax_msg)
    with np.load(path, allow_pickle=False) as z:
        fmt = str(z["format"]) if "format" in z.files else ""
        if not fmt.startswith("graphblas_tpu_torch.spmv_plan."):
            raise E.InvalidValue(jax_msg)
        if fmt != PLAN_FORMAT:
            raise E.InvalidValue(
                f"{path} is a {fmt} plan (sub-rows in row blocks); the "
                f"merge-path kernels read {PLAN_FORMAT} tilings: delete it "
                "and rebuild with Matrix.optimize(plan_path=...)")
        m, n, nnz, tile = (int(v) for v in z["shape"])
        if tile != _cuda.SPMV_TILE:
            raise E.InvalidValue(
                f"{path} tiles the walk by {tile} steps, the kernels by "
                f"{_cuda.SPMV_TILE}: rebuild it")
        return SpmvRoutePlan(
            m=m, n=n, nnz=nnz, tile_row=torch.from_numpy(z["tile_row"].copy()),
            digest=str(z["indptr_digest"]))


# ---------------------------------------------------------------------------
# the planned SpMV: kernel, plain version, wrappers
# ---------------------------------------------------------------------------

def _mul(mul: str, xg, a):
    """MUL(x_k, a_ik) as MULT_FNS in the JAX package: first = A value,
    second = x value, pair = 1."""
    if mul == "times":
        return xg * a
    if mul == "plus":
        return xg + a
    if mul == "first":
        return a
    if mul == "second":
        return xg
    return torch.ones_like(a)


def _repeat_arange(starts, lens):
    """concat(arange(s, s + l) for s, l in zip(starts, lens))."""
    total = int(lens.sum())
    off = torch.cumsum(lens, 0) - lens
    base = torch.repeat_interleave(starts - off, lens, output_size=total)
    return base + torch.arange(total, dtype=base.dtype, device=base.device)


def spmv_planned_plain(x, plan: SpmvRoutePlan, add: str,
                       mul: str) -> torch.Tensor:
    """Plain torch version of ``spmv_merge_planned``: walks the plan tile
    by tile as the kernel does.  Tile b takes the nonzeros
    [b * tile - tile_row[b], (b + 1) * tile - tile_row[b + 1]), gives each
    to the first of its rows tile_row[b] ... tile_row[b + 1] whose end lies
    past it, writes each row it ends (all but the last) with the partial of
    its own nonzeros, and carries the partial of the row open at its end
    into that row.  A row that no tile ends stays NaN, so a broken tiling
    shows in the result.  fp32 plus sums in fp64 (``spmv_onehot.ACC``)."""
    dev = plan.values.device
    m, nnz = plan.m, plan.nnz
    tr = plan.tile_row.long()
    tile = _cuda.SPMV_TILE
    tiles = torch.arange(tr.numel() - 1, device=dev)
    d0 = tiles * tile
    x0, x1 = tr[:-1], tr[1:]
    y0 = (d0 - x0).clamp(0, nnz)
    y1 = ((d0 + tile).clamp(max=m + nnz) - x1).clamp(0, nnz)
    lens = (y1 - y0).clamp(min=0)
    k = _repeat_arange(y0, lens)                  # nonzeros, tile by tile
    kt = torch.repeat_interleave(tiles, lens, output_size=k.numel())
    kr = torch.searchsorted(plan.indptr.long()[1:], k, right=True)
    kr = torch.minimum(torch.maximum(kr, x0[kt]), x1[kt])
    # partial of each (tile, row) the walk visits
    seg, inv = torch.unique(kt * (m + 1) + kr, return_inverse=True)
    xg = x[plan.indices[k]] if mul in ("times", "plus", "second") \
        else torch.zeros_like(plan.values[k])
    prod = _mul(mul, xg, plan.values[k])
    acc = ACC.get(x.dtype, x.dtype) if add == "plus" else x.dtype
    ident = MONOID_IDENTITY[add]
    part = torch.full((seg.numel(),), ident, dtype=acc, device=dev)
    if add == "plus":
        part.index_add_(0, inv, prod.to(acc))
    else:
        part.scatter_reduce_(0, inv, prod, "amin" if add == "min" else "amax")

    def partial(t, r):
        q = t * (m + 1) + r
        if seg.numel() == 0:
            return torch.full(q.shape, ident, dtype=acc, device=dev)
        pos = torch.searchsorted(seg, q).clamp(max=seg.numel() - 1)
        return torch.where(seg[pos] == q, part[pos], ident)

    y = torch.full((m,), math.nan, dtype=acc, device=dev)
    nr = (x1 - x0).clamp(min=0)
    rows = _repeat_arange(x0, nr)                 # rows each tile ends
    y[rows] = partial(torch.repeat_interleave(tiles, nr,
                                              output_size=rows.numel()),
                      rows)
    cut = x1 < m                                  # row open at a tile end
    cv = partial(tiles[cut], x1[cut])
    if add == "plus":
        y.index_add_(0, x1[cut], cv)
    else:
        y.scatter_reduce_(0, x1[cut], cv, "amin" if add == "min" else "amax")
    return y.to(x.dtype)


def _planned(x, plan: SpmvRoutePlan, add: str, mul: str, dtype,
             counter: str) -> torch.Tensor:
    if plan.values is None:
        raise E.InvalidValue("route plan is not bound to a matrix "
                             "(register_plan)")
    if add not in MONOID_IDENTITY or mul not in MULTIPLIES:
        raise E.InvalidValue(f"unsupported semiring {add}.{mul}")
    dev = plan.values.device
    with CFG.timed(f"kernels.{counter}", dev):
        if not plan.values.is_cuda:
            if plan.values.dtype != dtype or x.dtype != dtype:
                raise TypeError(
                    f"planned SpMV: expected {dtype} values and x")
            return spmv_planned_plain(x, plan, add, mul)
        _cuda.require(x, "x", dtype, dev, plan.n)
        _cuda.require(plan.values, "values", dtype, dev, plan.nnz)
        _cuda.require(plan.indices, "indices", torch.int32, dev, plan.nnz)
        _cuda.require(plan.indptr, "indptr", torch.int32, dev, plan.m + 1)
        _cuda.require(plan.tile_row, "tile_row", torch.int32, dev,
                      _cuda.spmv_tiles(plan.m, plan.nnz) + 1)
        y = torch.empty(plan.m, dtype=dtype, device=dev)
        if plan.ntiles:
            _cuda.spmv_merge_planned(plan.indptr, plan.tile_row,
                                     plan.indices, plan.values, x, y, add,
                                     mul)
            launches[counter] += 1
        return y


def spmv_route(x, plan: SpmvRoutePlan) -> torch.Tensor:
    """y = A @ x, plus-times fp32, through the plan (K1)."""
    return _planned(x, plan, "plus", "times", torch.float32, "spmv_route")


def spmv_route_monoid(x, plan: SpmvRoutePlan, *, add="min",
                      mul="plus") -> torch.Tensor:
    """y = A (add.mul) x in fp32 through the plan (K3).  Empty rows get
    the add identity (+inf for min: unreached in SSSP)."""
    return _planned(x, plan, add, mul, torch.float32, "spmv_route_monoid")


def spmv_route_ds(x, plan: SpmvRoutePlan) -> torch.Tensor:
    """y = A @ x in fp64 through a plan bound to fp64 values (K4)."""
    return _planned(x, plan, "plus", "times", torch.float64,
                    "spmv_route_ds")
