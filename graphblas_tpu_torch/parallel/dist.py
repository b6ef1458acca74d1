"""Distributed tier on torch.distributed: row-block partitioned matrices
over a DeviceMesh (counterpart of ``graphblas_tpu.parallel.dist``).

Execution model.  The JAX tier runs one controller over a Mesh.  Here
every rank is a process (``parallel.launch``), and every rank calls each
op with the same arguments, as the JAX controller calls it once.  A
``DistMatrix`` holds the calling rank's shard only, on the rank's device
(its card under NCCL, the CPU under gloo).  Results that the JAX tier
returns as one global array (``dist_mxv``, ``dist_vxm``,
``dist_bfs_levels``, ``dist_pagerank``, ``dist_mxv_2d``) come back whole
on every rank, gathered by ``all_gather_into_tensor`` of the row blocks.

Layout, shard for shard the JAX package's:
  * DistMatrix: 1-D row-block partition.  Rank d holds rows
    [d * rows_per, (d + 1) * rows_per) as a local CSR with GLOBAL column
    ids: ``indptr`` [rows_per + 1] (flat past the last row), ``indices``
    and ``values`` [cap] (cap = the largest shard's nnz; column 0 and
    value 0 past ``nnz``), and ``nnz``.
  * mxv: the x blocks all-gathered, then a local SpMV of the shard's
    first nnz entries on the port's SpMV kernels by their one predicate
    (``ops.mxm.spmv_kernel``: plus-times fp32 K2, or K1 once the shard
    has a plan; min / max / plus with five multiplies in fp32 K3;
    plus-times fp64 K4), and a gather + multiply + ``segment_reduce``
    otherwise.  ``overlap=True`` rotates the x blocks around a ring
    instead (``ensure_ring``).
  * vxm: each shard's partial over all columns, combined under the add
    monoid (``_combine_axis``); each rank keeps its slice.
  * BFS and PageRank loop on the host, one level or iteration a pass,
    with the exchanges of the JAX while-loops.
  * mxm: B all-gathered and compacted to one CSR, the rank's rows times B
    through the port's own ``mxm`` (SELL and K5 on the card).
  * save/load_sharded: ``shard{k}.npz`` + ``manifest.json``, the JAX
    package's files; either package loads the other's.
  * DistMatrix2D: block (i, j) of a (pr, pc) mesh with block-local
    column ids; x blocks broadcast over the r axis, the add monoid
    combined over the c axis.

Values cross the collectives in types every backend takes: bool as
uint8, INT8/UINT8/INT16 widened to int32, UINT16/32/64 in their signed
carriers (``types.carry``), MIN/MAX on the carriers' order keys; moves
without arithmetic (all-gather, the ring) send the bytes.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core import config as CFG
from ..core import monoid as MON
from ..core import semiring as SR
from ..core import types as T
from ..core.matrix import ROW, SPARSE, Matrix, _as_tensor
from ..core.semiring import Semiring
from ..kernels import segment as K
from ..ops.mxm import spmv_kernel


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError("graphblas_tpu_torch.parallel: no process group; "
                           "call parallel.launch.init, or run under "
                           "parallel.launch.spawn")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh_of(n: int, shape, names) -> DeviceMesh:
    world = dist.get_world_size()
    if n != world:
        raise ValueError(
            f"a mesh of {n} ranks needs a world of {n}, this one has "
            f"{world}: torch.distributed runs one process a rank, so the "
            "mesh takes the whole world (the JAX tier may take a prefix of "
            "its devices)")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=names)


def make_mesh(n_devices: int | None = None, axis: str = "d") -> DeviceMesh:
    """1-D mesh over the whole world (``n_devices`` must be its size)."""
    _device_type()
    n = n_devices or dist.get_world_size()
    return _mesh_of(n, (n,), (axis,))


def make_mesh_2d(pr: int, pc: int, axes=("r", "c")) -> DeviceMesh:
    """(pr, pc) mesh over the whole world; ``mesh.get_group(axes[1])``
    takes the place of a psum over the JAX mesh's column axis."""
    _device_type()
    return _mesh_of(pr * pc, (pr, pc), tuple(axes))


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ---------------------------------------------------------------------------
# collectives on any GraphBLAS type
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _tensor_collective():
    """``all_gather_into_tensor`` and ``reduce_scatter_tensor`` warn of
    their deprecation from torch 2.13 on; the names that replace them do
    not exist in 2.11, so the port keeps these and silences the warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        yield


def _gather(t: torch.Tensor, group) -> torch.Tensor:
    """[ndev, *t.shape]: every rank's ``t`` (one shape on every rank),
    by ``all_gather_into_tensor`` of its bytes."""
    n = dist.get_world_size(group)
    b = t.contiguous().reshape(-1).view(torch.uint8)
    out = torch.empty(n * b.numel(), dtype=torch.uint8, device=t.device)
    with _tensor_collective():
        dist.all_gather_into_tensor(out, b, group=group)
    return out.view(t.dtype).reshape((n,) + tuple(t.shape))


def _reduce_scatter(part: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the sum of every rank's ``part`` (int32 or
    float32, whose sums every backend takes)."""
    n = dist.get_world_size(group)
    out = torch.empty(part.numel() // n, dtype=part.dtype,
                      device=part.device)
    with _tensor_collective():
        dist.reduce_scatter_tensor(out, part, group=group)
    return out


_REDUCE_OP = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
              "max": dist.ReduceOp.MAX}


def _all_reduce(t: torch.Tensor, how: str, group) -> torch.Tensor:
    """A new tensor: ``t`` reduced over ``group`` by "sum", "min" or
    "max" in a wire type every backend takes.  Bool sums as max (lor);
    integer sums wrap modulo 2^w as on one device."""
    dt = t.dtype
    if dt == torch.bool:
        w = t.to(torch.uint8)
        how = "max" if how == "sum" else how
    elif T.wide_unsigned(dt):
        w = T.carry(t).clone()
        if how != "sum":
            w = T.order_key(w, dt)
    elif dt in (torch.int8, torch.uint8, torch.int16):
        w = t.to(torch.int32)
    else:
        w = t.clone()
    dist.all_reduce(w, _REDUCE_OP[how], group=group)
    if dt == torch.bool:
        return w != 0
    if T.wide_unsigned(dt):
        return T.uncarry(w if how == "sum" else T.order_key(w, dt), dt)
    return w.to(dt)


_COLLECTIVE = {"GrB_PLUS": "sum", "GrB_MIN": "min", "GrB_MAX": "max",
               "GrB_LOR": "max", "GxB_ANY": "max"}


def _combine_axis(partial: torch.Tensor, group, add) -> torch.Tensor:
    """Elementwise combine of every rank's partial under the add monoid.

    PLUS, MIN and MAX-like monoids ride ``all_reduce``; every other
    monoid (TIMES, LXOR, BAND, ...) all-gathers the partials and folds
    them in a log-depth tree, padded with the identity to a power of two,
    so every rank folds in the same order and float results agree
    bitwise across ranks."""
    how = _COLLECTIVE.get(add.op.name)
    if how is not None:
        return _all_reduce(partial, how, group)
    ty = T.lookup(partial.dtype)
    g = T.bits(_gather(partial, group))
    ndev = g.shape[0]
    pow2 = 1 << (ndev - 1).bit_length()
    if pow2 != ndev:
        ident = T.bits(add.identity_tensor(ty, partial.device))
        pad = ident.expand((pow2 - ndev,) + tuple(g.shape[1:]))
        g = torch.cat([g, pad])
    g = T.unbits(g, partial.dtype)
    while g.shape[0] > 1:
        h = g.shape[0] // 2
        g = T.cast(add.op.fn(g[:h], g[h:]), ty)
    return g[0]


# ---------------------------------------------------------------------------
# the shard a rank holds
# ---------------------------------------------------------------------------

class _Shard:
    """One rank's CSR block: its first ``nnz`` entries as tensors of their
    own (the kernels take exactly nnz entries, and ``spmv_route.plan_for``
    keys the shard's plans on these tensors), and, built at first use,
    their row ids and the values in another float type."""

    def __init__(self, indptr, indices, values, nnz: int):
        self.m = int(indptr.numel()) - 1
        self.indptr = indptr
        self.indices = indices[:nnz]
        self.values = values[:nnz]
        self.nnz = nnz
        self._rows = None
        self._vals = {values.dtype: self.values}

    @property
    def rows(self) -> torch.Tensor:
        if self._rows is None:
            self._rows = K.expand_rowids(self.indptr, self.nnz,
                                         self.m).long()
        return self._rows

    def values_as(self, dtype) -> torch.Tensor:
        v = self._vals.get(dtype)
        if v is None:
            v = self._vals[dtype] = self.values.to(dtype)
        return v


def _positional_mxv(kind, gi, gk):
    """Positional multiply in mxv context: A(i,k) x u(k): FIRSTI = i,
    FIRSTJ = SECONDI = k, SECONDJ = 0 (u is n-by-1)."""
    table = {"firsti": gi, "firsti1": gi + 1, "firstj": gk,
             "firstj1": gk + 1, "secondi": gk, "secondi1": gk + 1,
             "secondj": torch.zeros_like(gk),
             "secondj1": torch.ones_like(gk)}
    if kind not in table:
        raise NotImplementedError(f"positional {kind} on dist_mxv")
    return table[kind]


def _local_spmv(sh: _Shard, xfull, sr: Semiring, zt: T.Type, row0=0,
                col0=0) -> torch.Tensor:
    """y_local = A_local (+).(x) xfull over the shard's first nnz entries.

    With x already of the output type, the SpMV kernels by their one
    predicate (``ops.mxm.spmv_kernel``): plus-times fp32 on K2 (K1 once
    the shard has a plan), (min|max|plus) x (times|plus|first|second|
    pair) fp32 on K3, plus-times fp64 on K4, the plans built at first use
    (fp32 values are cast to fp64 for K4: exact).  Everything else,
    positional multiplies included, gathers, multiplies and reduces by
    row in torch.  Empty rows take the add identity on every tier."""
    if xfull.dtype == zt.torch_dtype:
        vals = sh.values_as(torch.float64) if (
            zt == T.FP64 and sh.values.dtype == torch.float32) else sh.values
        y = spmv_kernel(sh.indptr, sh.indices, vals, xfull, sh.m, sr,
                        build=True)
        if y is not None:
            return y
    CFG.burble("spmv: tier=torch")
    rows = sh.rows
    if sr.mult.positional:
        prod = _positional_mxv(sr.mult.positional, rows + row0,
                               sh.indices.long() + col0)
    else:
        prod = sr.mult.fn(sh.values, T.take(xfull, sh.indices.long()))
    return K.segment_reduce(T.cast(prod, zt), rows, sh.m, sr.add)


def _local_vxm_partial(sh: _Shard, xloc, row0: int, n_pad: int,
                       sr: Semiring, zt: T.Type) -> torch.Tensor:
    """This shard's contributions to every column, w[j] (+)= x[i] (x)
    A(i,j): a full-width [n_pad] partial, scattered by ``index_add_``
    (PLUS), ``scatter_reduce`` (MIN, MAX) or a sort (any other monoid);
    columns it does not reach hold the identity."""
    rows = sh.rows
    if sr.mult.positional:
        # vxm context: u'(i) x A(i,j): FIRSTI = 0 (u is 1-by-n),
        # FIRSTJ = SECONDI = i (global row), SECONDJ = j (global column)
        gi, gj = rows + row0, sh.indices.long()
        table = {"firsti": torch.zeros_like(gi), "firsti1":
                 torch.ones_like(gi), "firstj": gi, "firstj1": gi + 1,
                 "secondi": gi, "secondi1": gi + 1, "secondj": gj,
                 "secondj1": gj + 1}
        kind = sr.mult.positional
        if kind not in table:
            raise NotImplementedError(f"positional {kind} on dist_vxm")
        prod = table[kind]
    else:
        prod = sr.mult.fn(T.take(xloc, rows), sh.values)
    return K.segment_reduce(T.cast(prod, zt), sh.indices.long(), n_pad,
                            sr.add, indices_are_sorted=False)


# ---------------------------------------------------------------------------
# DistMatrix
# ---------------------------------------------------------------------------

def _vec(x, device) -> torch.Tensor:
    """A dense vector argument (numpy, list or tensor) as a 1-D tensor on
    ``device``."""
    return _as_tensor(x, device=device).reshape(-1)


_host = T.host      # a tensor on the host as numpy, any type


def _padded(src: torch.Tensor, cap: int) -> torch.Tensor:
    """``src`` followed by zeros up to ``cap`` elements (a view of src
    itself when it already has ``cap``)."""
    if src.numel() == cap:
        return src
    out = torch.zeros(cap, dtype=src.dtype, device=src.device)
    T.bits(out)[:src.numel()] = T.bits(src)
    return out


class DistMatrix:
    """Row-block partitioned sparse matrix: the calling rank's shard.

    Per rank (the JAX tier's stacked arrays at this rank's index):
      indptr  [rows_per + 1]  local row pointers, flat past the last row
      indices [cap]           global column ids (0 past nnz)
      values  [cap]           values (0 past nnz)
      nnz                     the shard's entry count (int)
    """

    def __init__(self, mesh: DeviceMesh, shape, indptr, indices, values,
                 nnz: int, rows_per: int, axis: str = "d"):
        self.mesh = mesh
        self.axis = axis
        self.shape = tuple(int(s) for s in shape)
        self.rows_per = int(rows_per)
        self.indptr = indptr
        self.indices = indices
        self.values = values
        self.nnz = int(nnz)
        self.group = mesh.get_group()
        self.rank = mesh.get_local_rank()
        self.device = indptr.device
        self.shard = _Shard(indptr, indices, values, self.nnz)
        self._ring = None

    @property
    def ndev(self) -> int:
        return self.mesh.size()

    @classmethod
    def from_matrix(cls, A: Matrix, mesh: DeviceMesh, axis: str = "d"
                    ) -> "DistMatrix":
        """This rank's row block of ``A`` (every rank passes the whole
        A), on the rank's device: rows padded so every rank owns
        ``rows_per``, entries padded to the largest shard's nnz."""
        ndev = mesh.size()
        d = mesh.get_local_rank()
        dev = _mesh_device(mesh)
        S = A.to_format(SPARSE, ROW)
        n = A.nrows
        rows_per = -(-n // ndev)
        ip = S.indptr.cpu().numpy().astype(np.int64)
        edges = np.minimum(np.arange(ndev + 1) * rows_per, n)  # row blocks
        cap = max(int(np.diff(ip[edges]).max()), 1)
        r0, r1 = int(edges[d]), int(edges[d + 1])
        base, cnt = int(ip[r0]), int(ip[r1] - ip[r0])
        loc = np.full(rows_per + 1, cnt, np.int32)
        loc[:r1 - r0 + 1] = ip[r0:r1 + 1] - base
        indices = _padded(S.indices[base:base + cnt].to(dev), cap)
        values = _padded(S._vals_expanded()[base:base + cnt].to(dev), cap)
        return cls(mesh, A.shape, torch.from_numpy(loc).to(dev), indices,
                   values, cnt, rows_per, axis)

    def ensure_ring(self):
        """Column-block layout for the ring ``dist_mxv``: the shard's
        entries grouped by the x block their column lies in, each group
        padded to one capacity (the largest over all ranks, at least 8),
        so ring step k touches only the entries of the block it holds.

          ring_idx [ndev * blk_cap]  LOCAL column ids (idx - blk * rp)
          ring_val [ndev * blk_cap]  values
          ring_row [ndev * blk_cap]  local row ids; rp marks padding
        Entries of block b sit at [b * blk_cap, (b + 1) * blk_cap), by
        row within it.  Built once, with one all-reduce of the capacity."""
        if self._ring is not None:
            return self._ring
        ndev, rp, sh = self.ndev, self.rows_per, self.shard
        idx, rows = sh.indices.long(), sh.rows
        blk = torch.clamp(idx // rp, max=ndev - 1)
        order = torch.argsort(blk * rp + rows, stable=True)
        cnt = torch.bincount(blk, minlength=ndev)
        blk_cap = max(8, int(_all_reduce(cnt.max(), "max", self.group)))
        sb = blk[order]
        starts = torch.cumsum(cnt, 0) - cnt
        pos = sb * blk_cap + torch.arange(sh.nnz, device=self.device) \
            - starts[sb]
        ring_idx = torch.zeros(ndev * blk_cap, dtype=torch.int32,
                               device=self.device)
        ring_idx[pos] = (idx[order] - sb * rp).to(torch.int32)
        ring_val = torch.zeros(ndev * blk_cap, dtype=sh.values.dtype,
                               device=self.device)
        T.bits(ring_val)[pos] = T.bits(sh.values)[order]
        ring_row = torch.full((ndev * blk_cap,), rp, dtype=torch.int64,
                              device=self.device)
        ring_row[pos] = rows[order]
        self._ring = (ring_idx, ring_val, ring_row, blk_cap)
        return self._ring

    def shard_x(self, x) -> torch.Tensor:
        """This rank's block of a dense length-n vector (zero-padded to
        rows_per)."""
        xt = _vec(x, self.device)
        r0 = min(self.rank * self.rows_per, self.shape[0])
        r1 = min(r0 + self.rows_per, self.shape[0])
        return _padded(xt[r0:r1], self.rows_per)

    def unshard_y(self, y: torch.Tensor) -> torch.Tensor:
        """The whole length-n vector from every rank's block ``y``."""
        return _gather(y, self.group).reshape(-1)[: self.shape[0]]


# ---------------------------------------------------------------------------
# public distributed ops
# ---------------------------------------------------------------------------

def _ztype(x: torch.Tensor, out_dtype) -> T.Type:
    return T.lookup(out_dtype) if out_dtype is not None else \
        T.lookup(x.dtype)


def _mask_accum(A, y, zt, mask, accum, c, mask_complement):
    """c<mask> (accum)= y on this rank's block (dense length-n mask and
    c, sharded like y)."""
    base = T.cast(A.shard_x(c), zt) if c is not None else \
        torch.zeros_like(y)
    if accum is not None:
        y = T.cast(accum.fn(base, y), zt)
    if mask is not None:
        keep = T.cast(A.shard_x(mask), T.BOOL) != mask_complement
        y = T.where(keep, y, base)
    return y


def _ring_spmv(A: DistMatrix, xloc, sr: Semiring, zt: T.Type):
    """The ring: x blocks move one hop left a step (each rank pulls from
    its right), by ``batch_isend_irecv``.  The next block's isend/irecv
    is issued before the current block's products, and waited on after
    them.  Each step reduces the arriving block's entries by row
    (``segment_reduce``; padding rows land in a dropped segment), and the
    add monoid folds the steps into the rank's rows.  ANY folds as
    ``segment_reduce`` reduces it, by a max (its operator keeps only its
    second operand, which would drop every step but the last), so the
    ring gives the all-gather path's bits."""
    ridx, rval, rrow, blk_cap = A.ensure_ring()
    ndev, rp, d = A.ndev, A.rows_per, A.rank
    left = dist.get_global_rank(A.group, (d - 1) % ndev)
    right = dist.get_global_rank(A.group, (d + 1) % ndev)
    if sr.add.op.name == "GxB_ANY":
        pair = torch.arange(rp, device=A.device).repeat(2)

        def fold(a, b):
            return K.segment_reduce(torch.cat([a, b]), pair, rp, sr.add,
                                    indices_are_sorted=False)
    else:
        def fold(a, b):
            return T.cast(sr.add.op.fn(a, b), zt)
    acc = None
    blk = xloc.contiguous()
    for k in range(ndev):
        if k < ndev - 1:
            nxt = torch.empty_like(blk)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, blk.view(torch.uint8), left, A.group),
                dist.P2POp(dist.irecv, nxt.view(torch.uint8), right,
                           A.group)])
        s0 = ((d + k) % ndev) * blk_cap
        seg = slice(s0, s0 + blk_cap)
        prod = T.cast(sr.mult.fn(rval[seg], T.take(blk, ridx[seg].long())),
                      zt)
        part = K.segment_reduce(prod, rrow[seg], rp + 1, sr.add)[:rp]
        acc = part if acc is None else fold(acc, part)
        if k < ndev - 1:
            for r in reqs:
                r.wait()
            blk = nxt
    return acc


def dist_mxv(A: DistMatrix, x, sr: Semiring = SR.PLUS_TIMES, out_dtype=None,
             mask=None, accum=None, c=None, mask_complement=False,
             overlap=False) -> torch.Tensor:
    """y = c<mask> (accum) A (+).(x) x, whole on every rank.  mask and c
    are dense length-n vectors, applied in-shard (the GrB C<M> += ...
    semantics on the distributed tier).

    By default the x blocks are all-gathered and each rank runs one local
    SpMV over its rows (``_local_spmv``: the kernels by predicate).
    ``overlap=True`` rotates the x blocks around a ring instead
    (``_ring_spmv``): each step multiplies only the entries whose columns
    lie in the block the rank holds, while the next block is in flight,
    and reduces them by row; the add monoid then folds the steps.  Same
    traffic as the all-gather, pipelined.  Positional semirings and a
    world of one rank take the all-gather path."""
    xs = A.shard_x(x)
    zt = _ztype(xs, out_dtype)
    if overlap and not sr.mult.positional and A.ndev > 1:
        y = _ring_spmv(A, xs, sr, zt)
    else:
        xfull = _gather(xs, A.group).reshape(-1)[: A.shape[1]]
        y = _local_spmv(A.shard, xfull, sr, zt, row0=A.rank * A.rows_per)
    y = _mask_accum(A, y, zt, mask, accum, c, mask_complement)
    return A.unshard_y(y)


def dist_vxm(A: DistMatrix, x, sr: Semiring = SR.PLUS_TIMES, out_dtype=None,
             mask=None, accum=None, c=None, mask_complement=False
             ) -> torch.Tensor:
    """w = c<mask> (accum) x' (+).(x) A, whole on every rank: each rank's
    partial over all columns, combined under the add monoid
    (``_combine_axis``); each rank keeps its slice, applies mask and
    accum in-shard, and the slices are gathered."""
    xs = A.shard_x(x)
    zt = _ztype(xs, out_dtype)
    n_pad = A.ndev * A.rows_per
    partial = _local_vxm_partial(A.shard, xs, A.rank * A.rows_per, n_pad,
                                 sr, zt)
    full = _combine_axis(partial, A.group, sr.add)
    mine = full[A.rank * A.rows_per:(A.rank + 1) * A.rows_per]
    mine = _mask_accum(A, mine, zt, mask, accum, c, mask_complement)
    return A.unshard_y(mine)


def dist_reduce_scalar(A: DistMatrix, mon=MON.PLUS) -> torch.Tensor:
    """The monoid's total of every stored value, a 0-d tensor on every
    rank.  Under ANY (combined by a max) a rank with no entries offers
    what ``segment_reduce`` gives an empty segment, the type's minimum,
    not the identity 0 that would beat every negative value; a matrix
    with no entries at all gives the identity, as ``full_reduce``."""
    sh = A.shard
    if mon.op.name != "GxB_ANY":
        local = K.full_reduce(sh.values, mon)
        return _combine_axis(local.reshape(1), A.group, mon)[0]
    one = torch.zeros(sh.nnz, dtype=torch.int64, device=A.device)
    local = K.segment_reduce(sh.values, one, 1, mon)
    top = _combine_axis(local, A.group, mon)[0]
    if not int(_all_reduce(torch.tensor([sh.nnz], device=A.device), "max",
                           A.group)):
        return mon.identity_tensor(T.lookup(top.dtype), A.device)
    return top


# ---------------------------------------------------------------------------
# distributed algorithms (host loops, one exchange a level / iteration)
# ---------------------------------------------------------------------------

def dist_bfs_levels(A: DistMatrix, source: int, frontier_cap: int = None
                    ) -> torch.Tensor:
    """Level-synchronous BFS: int32 levels (-1 unreached), whole on every
    rank.

    One ``all_reduce(MAX)`` a level carries both "is any frontier left"
    and "does any rank reach more than ``frontier_cap`` new candidates",
    so every rank takes the same exchange.  Small frontiers exchange
    sorted id lists (``all_gather_into_tensor`` of ``frontier_cap`` ids a
    rank), large ones the dense hit counts (``reduce_scatter_tensor`` of
    n_pad int32, then > 0)."""
    sh, rp, d = A.shard, A.rows_per, A.rank
    n_pad = A.ndev * rp
    fcap = frontier_cap or max(rp // 16, 128)
    dev = A.device
    row0 = d * rp
    gidx = torch.arange(rp, device=dev) + row0
    levels = torch.where(gidx == source, 0, -1).to(torch.int32)
    frontier = gidx == source
    rows, tgt = sh.rows, sh.indices.long()
    depth = 0
    while True:
        cand = torch.unique(tgt[frontier[rows]])      # sorted
        flags = torch.tensor([int(frontier.any()), int(cand.numel() > fcap)],
                             device=dev)
        any_left, large = _all_reduce(flags, "max", A.group).tolist()
        if not any_left:
            break
        if not large:
            ids = torch.full((fcap,), n_pad, dtype=torch.int64, device=dev)
            ids[:cand.numel()] = cand
            loc = _gather(ids, A.group).reshape(-1) - row0
            loc = loc[(loc >= 0) & (loc < rp)]
            mine = torch.zeros(rp, dtype=torch.bool, device=dev)
            mine[loc] = True
        else:
            part = torch.zeros(n_pad, dtype=torch.int32, device=dev)
            part[cand] = 1
            mine = _reduce_scatter(part, A.group) > 0
        mine &= levels < 0
        depth += 1
        levels[mine] = depth
        frontier = mine
    return A.unshard_y(levels)


def dist_pagerank(A: DistMatrix, damping=0.85, tol=1e-6, max_iter=100
                  ) -> torch.Tensor:
    """PageRank (fp32), whole on every rank.  Each iteration scatters the
    shard's contributions by ``index_add_``, sums them into each rank's
    block by ``reduce_scatter_tensor``, all-reduces the dangling mass and
    the L1 change, and tests ``tol`` / ``max_iter`` on the host."""
    sh, rp = A.shard, A.rows_per
    n = A.shape[0]
    n_pad = A.ndev * rp
    dev = A.device
    real = torch.arange(rp, device=dev) + A.rank * rp < n
    rows, tgt = sh.rows, sh.indices.long()
    outdeg = torch.diff(sh.indptr).to(torch.float32)
    r = torch.where(real, 1.0 / n, 0.0).to(torch.float32)
    teleport = float(np.float32((1.0 - damping) / n))
    safe_deg = torch.where(outdeg > 0, outdeg, 1.0)
    dangling = (outdeg == 0) & real
    it, delta = 0, np.inf
    while it < max_iter and delta > tol:
        w = r / safe_deg
        part = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        part.index_add_(0, tgt, w[rows])
        mine = _reduce_scatter(part, A.group)
        dang = _all_reduce(torch.where(dangling, r, 0.0).sum().reshape(1),
                           "sum", A.group)
        rn = damping * (mine + dang / n) + teleport
        rn = torch.where(real, rn, 0.0)
        delta = float(_all_reduce((rn - r).abs().sum().reshape(1), "sum",
                                  A.group))
        r = rn
        it += 1
    return A.unshard_y(r)


# ---------------------------------------------------------------------------
# distributed mxm (block-row SUMMA) and sharded checkpoint
# ---------------------------------------------------------------------------

def dist_mxm(A: DistMatrix, B: DistMatrix, sr: Semiring = SR.PLUS_TIMES,
             out_dtype=None) -> DistMatrix:
    """C = A (+).(x) B with both operands row-block partitioned.

    Block-row SUMMA: every rank all-gathers B's shards, compacts them to
    one CSR of B, and multiplies its own rows by it through the port's
    ``mxm`` (on the card the SELL engine and K5, or the fast tier where
    SELL declines).  C keeps A's row blocks; its shards are padded to the
    largest shard's nnz (the JAX tier pads to a flop bound)."""
    from .. import api
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"dist_mxm: {A.shape} x {B.shape}")
    zt = T.lookup(out_dtype) if out_dtype is not None else \
        T.lookup(A.values.dtype)
    g = B.group
    nz = _gather(torch.tensor([B.nnz], device=B.device), g).reshape(-1)
    capB = B.indices.numel()
    keep = (torch.arange(capB, device=B.device)[None, :] < nz[:, None]
            ).reshape(-1)
    bix = _gather(B.indices, g).reshape(-1)[keep]
    bv = T.unbits(T.bits(_gather(B.values, g)).reshape(-1)[keep],
                  B.values.dtype)
    offs = torch.cumsum(nz, 0) - nz
    bip = (_gather(B.indptr, g)[:, :-1].long() + offs[:, None]).reshape(-1)
    bip = torch.cat([bip[: B.shape[0]], nz.sum().reshape(1)])
    Bm = Matrix(B.shape, T.lookup(B.values.dtype), SPARSE, ROW,
                indptr=bip.to(torch.int32), indices=bix, values=bv)
    sh = A.shard
    Ai = Matrix((A.rows_per, A.shape[1]), T.lookup(A.values.dtype), SPARSE,
                ROW, indptr=sh.indptr, indices=sh.indices, values=sh.values)
    C = api.mxm(Ai, Bm, sr, out_dtype=zt).to_format(SPARSE, ROW)
    cnt = int(C.indices.numel())
    cap = max(int(_all_reduce(torch.tensor([cnt], device=A.device), "max",
                              A.group)), 1)
    return DistMatrix(A.mesh, (A.shape[0], B.shape[1]), C.indptr,
                      _padded(C.indices, cap),
                      _padded(C._vals_expanded(), cap), cnt, A.rows_per,
                      A.axis)


def save_sharded(A: DistMatrix, directory) -> None:
    """Sharded checkpoint: rank k writes ``shard{k}.npz`` (indptr,
    indices, values, nnz) and rank 0 ``manifest.json``, the files the JAX
    package writes; returns when every rank has written."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    vals = _host(A.values)
    np.savez(d / f"shard{A.rank}.npz", indptr=_host(A.indptr),
             indices=_host(A.indices), values=vals, nnz=np.int32(A.nnz))
    if A.rank == 0:
        (d / "manifest.json").write_text(json.dumps({
            "shape": list(A.shape), "rows_per": A.rows_per,
            "ndev": A.ndev, "axis": A.axis, "dtype": str(vals.dtype)}))
    dist.barrier(group=A.group)


def load_sharded(directory, mesh: DeviceMesh) -> DistMatrix:
    """This rank's shard of a checkpoint written by ``save_sharded`` (of
    either package).  The manifest's ``ndev`` must be the mesh's size."""
    d = pathlib.Path(directory)
    man = json.loads((d / "manifest.json").read_text())
    if man["ndev"] != mesh.size():
        raise ValueError(f"{d} holds {man['ndev']} shards; the mesh has "
                         f"{mesh.size()} ranks")
    dev = _mesh_device(mesh)
    with np.load(d / f"shard{mesh.get_local_rank()}.npz") as p:
        ip, ix, vl, nz = (p[k] for k in ("indptr", "indices", "values",
                                         "nnz"))
    return DistMatrix(mesh, tuple(man["shape"]), _vec(ip, dev),
                      _vec(ix, dev), _vec(vl, dev), int(nz),
                      man["rows_per"], man["axis"])


# ---------------------------------------------------------------------------
# 2-D block partition
# ---------------------------------------------------------------------------

class DistMatrix2D:
    """2-D block-partitioned sparse matrix over an (r, c) mesh: the
    calling rank's block.

    Rank (i, j) owns A[i*rb:(i+1)*rb, j*cb:(j+1)*cb] as a local CSR with
    block-local column ids, padded to the largest block's nnz: the JAX
    tier's arrays at [i, j].  SpMV: x block j on the ranks of mesh column
    j, a local block SpMV, the add monoid combined over the c axis."""

    def __init__(self, mesh, shape, indptr, indices, values, nnz: int,
                 rb: int, cb: int):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.indptr = indptr
        self.indices = indices
        self.values = values
        self.nnz = int(nnz)
        self.rb, self.cb = int(rb), int(cb)
        self.coord = tuple(mesh.get_coordinate())
        self.device = indptr.device
        self.shard = _Shard(indptr, indices, values, self.nnz)

    @classmethod
    def from_matrix(cls, A: Matrix, mesh: DeviceMesh) -> "DistMatrix2D":
        pr, pc = mesh.shape
        i, j = mesh.get_coordinate()
        dev = _mesh_device(mesh)
        S = A.to_format(SPARSE, ROW)
        m, n = A.shape
        rb, cb = -(-m // pr), -(-n // pc)
        nnz = int(S.indices.numel())
        rows = K.expand_rowids(S.indptr, nnz, m).long()
        cols = S.indices.long()
        blk = (rows // rb) * pc + cols // cb
        counts = torch.bincount(blk, minlength=pr * pc)
        cap = max(int(counts.max()), 1)
        sel = blk == i * pc + j                # CSR order within the block
        lr = rows[sel] - i * rb
        ip = torch.zeros(rb + 1, dtype=torch.int64, device=rows.device)
        torch.cumsum(torch.bincount(lr, minlength=rb), 0, out=ip[1:])
        ix = (cols[sel] - j * cb).to(torch.int32)
        vl = T.unbits(T.bits(S._vals_expanded())[sel], S.values.dtype)
        return cls(mesh, A.shape, ip.to(torch.int32).to(dev),
                   _padded(ix.to(dev), cap), _padded(vl.to(dev), cap),
                   int(sel.sum()), rb, cb)


def dist_mxv_2d(A: DistMatrix2D, x, sr: Semiring = SR.PLUS_TIMES,
                out_dtype=None) -> torch.Tensor:
    """y = A (+).(x) x over the 2-D partition, whole on every rank: rank
    (0, j) broadcasts x block j over the r axis, each rank runs the local
    SpMV of its block (``_local_spmv``'s tiers), the add monoid combines
    over the c axis, and the row blocks are gathered over the r axis."""
    axr, axc = A.mesh.mesh_dim_names
    gr, gc = A.mesh.get_group(axr), A.mesh.get_group(axc)
    i, j = A.coord
    xt = _vec(x, A.device)
    zt = _ztype(xt, out_dtype)
    xb = torch.zeros(A.cb, dtype=xt.dtype, device=A.device)
    if i == 0:
        lo = min(j * A.cb, xt.numel())
        hi = min(lo + A.cb, xt.numel())
        T.bits(xb)[:hi - lo] = T.bits(xt)[lo:hi]
    dist.broadcast(xb.view(torch.uint8), src=dist.get_global_rank(gr, 0),
                   group=gr)
    y = _local_spmv(A.shard, xb, sr, zt, row0=i * A.rb, col0=j * A.cb)
    full = _combine_axis(y, gc, sr.add)
    return _gather(full, gr).reshape(-1)[: A.shape[0]]
