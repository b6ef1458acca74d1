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
is only what balances the work: a partition of the rows into blocks of
about equal nonzero count, with rows longer than ``row_cap`` split into
sub-rows whose partial results land in ``y[m:m_sub]`` and are folded back
into their ``extra_owner`` row by the wrapper, as the JAX wrapper folds its
extras outside the kernel.  The fold is bitwise reproducible: each
owner's extras are gathered through a padded (owners, max extras) table
and reduced along it in one pass, with no atomics.  One CUDA template,
``spmv_planned<T, ADD, MUL>`` in ``csrc/spmv.cu``, serves all three entry
points (16 instantiations).  It is bound by device-memory bytes (~12 B
per nonzero plus the x gather, 8 B more in fp64): coalesced loads of the
CSR arrays, x through the read-only path, one warp per sub-row, reduce in
registers.

Each entry point launches the kernel for CUDA tensors and runs the plain
torch version, which walks the same plan (blocks, sub-rows,
``extra_owner``), for CPU tensors.

Plans are cached per matrix with identity-checked keys, and save/load to
an ``.npz`` of the port's own format.  Plans written by the JAX package
(a TPU route layout) are refused.
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
from . import _cuda
from .spmv_onehot import ACC

ROW_CAP = 512        # rows longer than this split into sub-rows
BLOCK_COST = 4096    # nonzeros (+ ROW_COST per sub-row) per 8-warp block
ROW_COST = 4
PLAN_FORMAT = "graphblas_tpu_torch.spmv_plan.v1"

MONOID_IDENTITY = {"plus": 0.0, "min": math.inf, "max": -math.inf}
MULTIPLIES = ("times", "plus", "first", "second", "pair")

# launches of the CUDA kernel per entry point (CPU calls are uncounted)
launches = {"spmv_route": 0, "spmv_route_monoid": 0, "spmv_route_ds": 0}


def _digest(indptr) -> str:
    ip = np.ascontiguousarray(_host(indptr), np.int64)
    return hashlib.sha256(ip.tobytes()).hexdigest()


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@dataclasses.dataclass(eq=False)
class SpmvRoutePlan:
    """Row partition of one CSR matrix, plus (when bound) its arrays.

    Sub-row r covers entries [sub_start[r], sub_end[r]); r < m is row r's
    first chunk, r >= m an extra chunk of row extra_owner[r - m].  Block b
    owns sub-rows [block_ptr[b], block_ptr[b + 1])."""

    m: int
    n: int
    m_sub: int
    nnz: int
    row_cap: int
    sub_start: torch.Tensor       # (m_sub,) int32
    sub_end: torch.Tensor         # (m_sub,) int32
    block_ptr: torch.Tensor       # (nblocks + 1,) int32
    extra_owner: torch.Tensor | None   # (m_sub - m,) int64
    indptr_digest: str
    indptr: torch.Tensor | None = None
    indices: torch.Tensor | None = None
    values: torch.Tensor | None = None
    # the fold of the extras, derived from extra_owner (_fold_table)
    fold_owner: torch.Tensor | None = dataclasses.field(init=False,
                                                        default=None)
    fold_table: torch.Tensor | None = dataclasses.field(init=False,
                                                        default=None)

    def __post_init__(self):
        if self.extra_owner is not None:
            self.fold_owner, self.fold_table = _fold_table(self.extra_owner)

    @property
    def nblocks(self) -> int:
        return int(self.block_ptr.numel()) - 1

    @property
    def device(self) -> torch.device:
        return self.sub_start.device

    def matches(self, indptr, shape) -> bool:
        """True when this plan partitions a matrix with this indptr."""
        return (tuple(shape) == (self.m, self.n)
                and int(indptr.shape[0]) == self.m + 1
                and _digest(indptr) == self.indptr_digest)

    def bind(self, indptr, indices, values) -> "SpmvRoutePlan":
        """The plan attached to a matrix's CSR arrays (moved to their
        device)."""
        if not self.matches(indptr, (self.m, self.n)) \
                or int(indices.shape[0]) != self.nnz \
                or int(values.shape[0]) != self.nnz:
            raise E.InvalidValue("route plan does not match this matrix")
        dev = values.device
        eo = self.extra_owner
        return dataclasses.replace(
            self, sub_start=self.sub_start.to(dev),
            sub_end=self.sub_end.to(dev),
            block_ptr=self.block_ptr.to(dev),
            extra_owner=None if eo is None else eo.to(dev),
            indptr=indptr, indices=indices, values=values)


def _fold_table(owner):
    """(owners, table): the rows that own extra sub-rows, ascending, and
    per owner the positions of its extras in y_sub[m:], padded to the
    longest list with k = owner.numel(), the slot that holds the add
    identity in ``_fold_extras``."""
    k = owner.numel()
    dev = owner.device
    order = torch.argsort(owner, stable=True)
    owners, cnt = torch.unique_consecutive(owner[order], return_counts=True)
    first = torch.cumsum(cnt, 0) - cnt
    col = torch.arange(k, device=dev) - torch.repeat_interleave(first, cnt)
    row = torch.repeat_interleave(torch.arange(owners.numel(), device=dev),
                                  cnt)
    table = torch.full((owners.numel(), int(cnt.max())), k,
                       dtype=torch.int64, device=dev)
    table[row, col] = order
    return owners, table


def build_plan(indptr, indices, values, shape, row_cap: int = ROW_CAP,
               block_cost: int = BLOCK_COST) -> SpmvRoutePlan:
    """Build the plan for a CSR matrix (host numpy work; the partition
    lands on the arrays' device, bound to them)."""
    m, n = int(shape[0]), int(shape[1])
    ip = np.ascontiguousarray(_host(indptr), np.int64)
    counts = np.diff(ip)
    nnz = int(ip[-1]) if ip.size else 0
    nxtra = np.maximum(-(-counts // row_cap) - 1, 0)
    k = int(nxtra.sum())
    m_sub = m + k
    start = np.empty(m_sub, np.int64)
    end = np.empty(m_sub, np.int64)
    start[:m] = ip[:-1]
    end[:m] = ip[:-1] + np.minimum(counts, row_cap)
    owner = None
    if k:
        heavy = np.flatnonzero(nxtra)
        owner = np.repeat(heavy, nxtra[heavy])
        first = np.cumsum(nxtra[heavy]) - nxtra[heavy]     # per heavy row
        chunk = np.arange(k) - np.repeat(first, nxtra[heavy]) + 1
        start[m:] = ip[owner] + chunk * row_cap
        end[m:] = np.minimum(start[m:] + row_cap, ip[owner + 1])
    cost = np.zeros(m_sub + 1, np.int64)
    np.cumsum(end - start + ROW_COST, out=cost[1:])
    nb = max(1, -(-int(cost[-1]) // block_cost))
    cuts = np.searchsorted(cost, np.arange(1, nb) * block_cost)
    block_ptr = np.unique(np.concatenate([[0], cuts, [m_sub]]))
    dev = values.device if isinstance(values, torch.Tensor) else "cpu"
    plan = SpmvRoutePlan(
        m=m, n=n, m_sub=m_sub, nnz=nnz, row_cap=row_cap,
        sub_start=torch.as_tensor(start.astype(np.int32), device=dev),
        sub_end=torch.as_tensor(end.astype(np.int32), device=dev),
        block_ptr=torch.as_tensor(block_ptr.astype(np.int32), device=dev),
        extra_owner=(None if owner is None else
                     torch.as_tensor(owner.astype(np.int64), device=dev)),
        indptr_digest=_digest(ip))
    CFG.burble("route plan: m=%d sub-rows=%d blocks=%d", m, m_sub,
               plan.nblocks)
    if isinstance(values, torch.Tensor):
        plan = dataclasses.replace(plan, indptr=indptr, indices=indices,
                                   values=values)
    return plan


# ---------------------------------------------------------------------------
# plan cache + serialization
# ---------------------------------------------------------------------------

_plan_cache: dict = {}


def plan_for(indptr, indices, values, shape, build=True):
    """Per-matrix cached plan.  Strong refs pin the source tensors and
    identity is re-checked on a hit.  With ``build=False`` only returns an
    already-cached plan (callers opt in through Matrix.optimize() or the
    algorithms' ``optimize=True``)."""
    key = (id(indptr), id(indices), id(values), tuple(shape))
    ent = _plan_cache.get(key)
    if ent is not None and ent[0] is indptr and ent[1] is indices \
            and ent[2] is values:
        return ent[3]
    if not build:
        return None
    p = build_plan(indptr, indices, values, shape)
    register_plan(indptr, indices, values, shape, p)
    return p


def register_plan(indptr, indices, values, shape, plan):
    """Associate a (loaded or built) plan with a matrix's arrays."""
    if plan.values is not values or plan.indices is not indices:
        plan = plan.bind(indptr, indices, values)
    key = (id(indptr), id(indices), id(values), tuple(shape))
    if len(_plan_cache) > 8:
        _plan_cache.clear()
    _plan_cache[key] = (indptr, indices, values, plan)
    return plan


def save_plan(plan: SpmvRoutePlan, path) -> None:
    """Write the partition (not the matrix) to ``path`` as an .npz in the
    port's format, under exactly that name."""
    eo = plan.extra_owner
    with open(path, "wb") as f:
        np.savez(f, format=np.array(PLAN_FORMAT),
                 shape=np.array([plan.m, plan.n, plan.m_sub, plan.nnz,
                                 plan.row_cap], np.int64),
                 sub_start=_host(plan.sub_start),
                 sub_end=_host(plan.sub_end),
                 block_ptr=_host(plan.block_ptr),
                 extra_owner=(np.zeros(0, np.int64) if eo is None
                              else _host(eo)),
                 indptr_digest=np.array(plan.indptr_digest))


def load_plan(path) -> SpmvRoutePlan:
    """Read a plan written by ``save_plan`` (unbound, on the CPU; bind it
    with ``register_plan``).  A JAX route plan is a TPU layout and is
    refused."""
    jax_msg = (f"{path} is a graphblas_tpu (JAX) route plan, a TPU layout "
               "the port cannot run; build the port's plan with "
               "Matrix.optimize(plan_path=...) or spmv_route.save_plan")
    if os.path.isdir(path):
        raise E.InvalidValue(jax_msg)
    with np.load(path, allow_pickle=False) as z:
        if "format" not in z.files or str(z["format"]) != PLAN_FORMAT:
            raise E.InvalidValue(jax_msg)
        m, n, m_sub, nnz, row_cap = (int(v) for v in z["shape"])
        eo = z["extra_owner"]
        return SpmvRoutePlan(
            m=m, n=n, m_sub=m_sub, nnz=nnz, row_cap=row_cap,
            sub_start=torch.from_numpy(z["sub_start"].copy()),
            sub_end=torch.from_numpy(z["sub_end"].copy()),
            block_ptr=torch.from_numpy(z["block_ptr"].copy()),
            extra_owner=torch.from_numpy(eo.copy()) if eo.size else None,
            indptr_digest=str(z["indptr_digest"]))


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
    """Plain torch version of ``spmv_planned``: y_sub over the plan's
    sub-rows, visited block by block.  A sub-row no block visits stays
    NaN, so a broken partition shows in the result.  fp32 plus sums in
    fp64 (``spmv_onehot.ACC``)."""
    dev = plan.values.device
    bp = plan.block_ptr.long()
    sub = _repeat_arange(bp[:-1], bp[1:] - bp[:-1])     # visited sub-rows
    s = plan.sub_start.long()[sub]
    lens = plan.sub_end.long()[sub] - s
    pos = _repeat_arange(s, lens)
    seg = torch.repeat_interleave(sub, lens, output_size=pos.shape[0])
    a = plan.values[pos]
    xg = x[plan.indices[pos]] if mul in ("times", "plus", "second") \
        else torch.zeros_like(a)
    prod = _mul(mul, xg, a)
    acc = ACC.get(x.dtype, x.dtype) if add == "plus" else x.dtype
    y_sub = torch.full((plan.m_sub,), math.nan, dtype=acc, device=dev)
    y_sub[sub] = MONOID_IDENTITY[add]
    if add == "plus":
        return y_sub.index_add_(0, seg, prod.to(acc)).to(x.dtype)
    return y_sub.scatter_reduce_(0, seg, prod,
                                 "amin" if add == "min" else "amax",
                                 include_self=True)


def _fold_extras(y_sub, plan: SpmvRoutePlan, add: str) -> torch.Tensor:
    """y = y_sub[:m] with each extra sub-row folded into its owner row:
    the owner's extras, gathered through ``plan.fold_table`` (pads read
    the identity), reduce along the table's rows, then combine with the
    owner's first chunk.  No atomics, so the order is fixed."""
    y = y_sub[:plan.m]
    if plan.extra_owner is None:
        return y
    ext = torch.cat([y_sub[plan.m:plan.m_sub],
                     y_sub.new_full((1,), MONOID_IDENTITY[add])])
    g = ext[plan.fold_table]
    own = plan.fold_owner
    y = y.clone()
    if add == "plus":
        y[own] = y[own] + g.sum(1)
    elif add == "min":
        y[own] = torch.minimum(y[own], g.amin(1))
    else:
        y[own] = torch.maximum(y[own], g.amax(1))
    return y


def _planned(x, plan: SpmvRoutePlan, add: str, mul: str, dtype,
             counter: str) -> torch.Tensor:
    if plan.values is None:
        raise E.InvalidValue("route plan is not bound to a matrix "
                             "(register_plan)")
    if add not in MONOID_IDENTITY or mul not in MULTIPLIES:
        raise E.InvalidValue(f"unsupported semiring {add}.{mul}")
    if not plan.values.is_cuda:
        if plan.values.dtype != dtype or x.dtype != dtype:
            raise TypeError(f"planned SpMV: expected {dtype} values and x")
        return _fold_extras(spmv_planned_plain(x, plan, add, mul), plan,
                            add)
    dev = plan.values.device
    _cuda.require(x, "x", dtype, dev, plan.n)
    _cuda.require(plan.values, "values", dtype, dev, plan.nnz)
    _cuda.require(plan.indices, "indices", torch.int32, dev, plan.nnz)
    for name in ("sub_start", "sub_end"):
        _cuda.require(getattr(plan, name), name, torch.int32, dev,
                      plan.m_sub)
    _cuda.require(plan.block_ptr, "block_ptr", torch.int32, dev)
    y_sub = torch.empty(plan.m_sub, dtype=dtype, device=dev)
    _cuda.spmv_planned(plan.sub_start, plan.sub_end, plan.block_ptr,
                       plan.indices, plan.values, x, y_sub, add, mul)
    launches[counter] += 1
    return _fold_extras(y_sub, plan, add)


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
