"""Static permutations, out.flat[p] = x.flat[perm[p]]: the counterpart of
the executors of ``graphblas_tpu.kernels.static_route`` (K9).

  * ``global_permute(x, plan)``  replaces ``global_permute`` (l.580): an
    n-element array through a ``GlobalPermutePlan``
  * ``tile_permute(x, perm)``    replaces ``tile_permute`` (l.420): one
    (R, 128) tile, ``perm`` over its R * 128 slots
  * ``sublane_permute(x, perm_cols)`` replaces ``sublane_permute``
    (l.400): lane column l of an (R, 128) tile permuted on its own,
    ``out[r, l] = x[perm_cols[l, r], l]``
  * ``permute_rows(x, perm, *more)``: the unchecked entry under them and
    under the CSR <-> CSC reorient (``core/convert.py``): rows of ``x``
    and of at most one more payload through one permutation

The TPU executors run Benes and Clos networks built by host planners
(``benes_route``, ``clos_route``, the two-phase ``GlobalPermutePlan``)
because the TensorCore cannot gather.  Hopper gathers from device memory,
so the port takes the permutation itself: every entry point is one call
of ``gb_permute_gather`` (``csrc/permute.cu``) for CUDA tensors, counted
in ``launches``, and the plain version ``permute_plain`` for CPU tensors.
Rows are of any type and width (1, 2, 4, 8, 16 bytes, struct rows);
permutations are int32 or int64.  The public entry points check their
permutations (every index in range, each used once) where they enter:
in ``GlobalPermutePlan`` once, and on every call that is given a bare
permutation.  ``permute_rows`` checks nothing: its callers pass a sort's
order, whose check would cost host syncs.
"""

from __future__ import annotations

import torch

import math

from ..core import config as CFG
from ..core import types as T
from . import _cuda

LANES = 128

# calls of the CUDA kernel, all its passes one call (CPU calls run the
# plain version, uncounted)
launches = 0


def _checked(perm, n: int, device) -> torch.Tensor:
    """``perm`` as a contiguous int32 tensor on ``device``, after checking
    that it is a permutation of range(n)."""
    p = torch.as_tensor(perm, device=device).reshape(-1)
    if p.dtype.is_floating_point or p.dtype == torch.bool:
        raise TypeError(f"permutation of dtype {p.dtype}")
    if p.numel() != n:
        raise ValueError(f"permutation of {p.numel()} entries for {n}")
    if n:
        lo, hi = torch.aminmax(p)
        if int(lo) < 0 or int(hi) >= n:
            raise ValueError("permutation index out of range")
        seen = torch.zeros(n, dtype=torch.bool, device=p.device)
        seen[p.long()] = True
        if not bool(seen.all()):
            raise ValueError("not a permutation: an index repeats")
    return p.to(torch.int32).contiguous()


class GlobalPermutePlan:
    """out.flat = x.flat[perm] for arrays of n elements: the permutation,
    checked once and held on the device as int32 (the counterpart of the
    JAX two-phase Clos plan; the card gathers through it directly)."""

    __slots__ = ("perm", "n")

    def __init__(self, perm, n, device=None):
        if device is None and not isinstance(perm, torch.Tensor):
            device = CFG.default_device()
        self.n = int(n)
        self.perm = _checked(perm, self.n, device)


def permute_plain(x, perm, *more):
    """Plain version of K9: ``x[perm]`` (rows: dim 0), and each of ``more``
    through the same ``perm`` (then a tuple)."""
    idx = perm.long()
    outs = tuple(T.take(t, idx) for t in (x,) + more)
    return outs if more else outs[0]


def permute_rows(x, perm, *more):
    """out_k[p] = x_k[perm[p]] over the rows (dim 0) of ``x`` and of at
    most one tensor in ``more``, through one K9 launch when the tensors lie
    on the card, ``permute_plain`` when they lie on the CPU (a tuple of
    both outputs when ``more`` is given).  ``perm`` is a 1-D int32 or int64
    tensor whose entries the caller vouches for: each in [0, rows of x)."""
    if len(more) > 1:
        raise ValueError(f"permute_rows: one or two payloads, got "
                         f"{1 + len(more)}")
    xs = (x,) + more
    if not (perm.is_cuda or any(t.is_cuda for t in xs)):
        return permute_plain(x, perm, *more)
    dev = perm.device
    if perm.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"permute_rows: perm of dtype {perm.dtype}")
    if perm.dim() != 1 or not perm.is_contiguous():
        raise ValueError("permute_rows: perm must be a contiguous 1-D "
                         "tensor")
    nx = int(x.shape[0]) if x.dim() else -1
    for t in xs:
        if t.device != dev:
            raise ValueError(f"permute_rows: payload on {t.device}, perm "
                             f"on {dev}")
        if t.dim() == 0 or int(t.shape[0]) != nx:
            raise ValueError("permute_rows: payloads of different lengths")
        if not t.is_contiguous():
            raise ValueError("permute_rows: payloads must be contiguous")
    n = perm.numel()
    outs = tuple(torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                             device=dev) for t in xs)
    row_bytes = [t.element_size() * math.prod(t.shape[1:]) for t in xs]
    if n and min(row_bytes):
        if not nx:
            raise ValueError("permute_rows: indices into an empty payload")
        _cuda.permute_gather(perm, xs, outs, row_bytes, nx)
        global launches
        launches += 1
    return outs if more else outs[0]


def global_permute(x, plan) -> torch.Tensor:
    """out.flat[p] = x.flat[perm[p]], shaped as ``x`` (K9).  ``plan`` is a
    ``GlobalPermutePlan`` or a bare permutation (checked on this call)."""
    n = x.numel()
    if not isinstance(plan, GlobalPermutePlan):
        return permute_rows(x.reshape(-1), _checked(plan, n, x.device)
                            ).reshape(x.shape)
    if plan.n != n:
        raise ValueError(f"plan for {plan.n} elements, x has {n}")
    return permute_rows(x.reshape(-1), plan.perm).reshape(x.shape)


def _tile_rows(x) -> int:
    if x.dim() != 2 or x.shape[1] != LANES:
        raise ValueError(f"expected an (R, {LANES}) tile, got "
                         f"{tuple(x.shape)}")
    return int(x.shape[0])


def tile_permute(x, perm) -> torch.Tensor:
    """out.flat = x.flat[perm] over one (R, 128) tile (K9)."""
    _tile_rows(x)
    return global_permute(x, perm)


def sublane_permute(x, perm_cols) -> torch.Tensor:
    """Each lane column of the (R, 128) tile ``x`` permuted on its own:
    out[r, l] = x[perm_cols[l, r], l], perm_cols of shape (128, R) (K9)."""
    R = _tile_rows(x)
    pc = torch.as_tensor(perm_cols, device=x.device)
    if tuple(pc.shape) != (LANES, R):
        raise ValueError(f"perm_cols of shape {tuple(pc.shape)}, expected "
                         f"({LANES}, {R})")
    lane = torch.arange(LANES, device=x.device)
    flat = pc.long().T * LANES + lane                  # (R, 128) sources
    # each column a permutation of range(R) <=> flat one of range(R * 128)
    return permute_rows(x.reshape(-1), _checked(flat, R * LANES, x.device)
                        ).reshape(R, LANES)
