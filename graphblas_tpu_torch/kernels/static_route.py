"""Static permutations, out.flat[p] = x.flat[perm[p]]: the counterpart of
the executors of ``graphblas_tpu.kernels.static_route`` (K9).

  * ``global_permute(x, plan)``  replaces ``global_permute`` (l.580): an
    n-element array through a ``GlobalPermutePlan``
  * ``tile_permute(x, perm)``    replaces ``tile_permute`` (l.420): one
    (R, 128) tile, ``perm`` over its R * 128 slots
  * ``sublane_permute(x, perm_cols)`` replaces ``sublane_permute``
    (l.400): lane column l of an (R, 128) tile permuted on its own,
    ``out[r, l] = x[perm_cols[l, r], l]``

The TPU executors run Benes and Clos networks built by host planners
(``benes_route``, ``clos_route``, the two-phase ``GlobalPermutePlan``)
because the TensorCore cannot gather.  Hopper gathers from device memory,
so the port takes the permutation itself and has no planner: every entry
point is one launch of ``permute_gather_32`` (``csrc/permute.cu``) for
CUDA tensors, counted in ``launches``, and the plain version
``x.reshape(-1)[perm]`` for CPU tensors.  Elements are any 32-bit type.
Permutations are checked (every index in range, each used once) where
they enter: in ``GlobalPermutePlan`` once, and on every call that is
given a bare permutation.
"""

from __future__ import annotations

import torch

from ..core import config as CFG
from . import _cuda

LANES = 128

# launches of the CUDA kernel (CPU calls run the plain version, uncounted)
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
    checked once and held on the device as int32 (the port's counterpart
    of the JAX two-phase Clos plan, which it does not need)."""

    __slots__ = ("perm", "n")

    def __init__(self, perm, n, device=None):
        if device is None and not isinstance(perm, torch.Tensor):
            device = CFG.default_device()
        self.n = int(n)
        self.perm = _checked(perm, self.n, device)


def permute_plain(x, perm) -> torch.Tensor:
    """Plain version of ``permute_gather_32``: x.flat[perm] (1-D)."""
    return x.reshape(-1)[perm.long()]


def _gather(x, perm) -> torch.Tensor:
    """x.flat[perm] (1-D; ``perm`` already checked)."""
    if not x.is_cuda:
        return permute_plain(x, perm)
    if x.element_size() != 4 or x.is_complex():
        raise TypeError(f"permute_gather_32: elements of {x.dtype}")
    xf = x.reshape(-1)
    _cuda.require(xf, "x", x.dtype, x.device)
    _cuda.require(perm, "perm", torch.int32, x.device)
    out = torch.empty(perm.numel(), dtype=x.dtype, device=x.device)
    _cuda.permute_gather_32(xf, perm, out)
    global launches
    launches += 1
    return out


def global_permute(x, plan) -> torch.Tensor:
    """out.flat[p] = x.flat[perm[p]], shaped as ``x`` (K9).  ``plan`` is a
    ``GlobalPermutePlan`` or a bare permutation (checked on this call)."""
    n = x.numel()
    if isinstance(plan, GlobalPermutePlan):
        if plan.n != n:
            raise ValueError(f"plan for {plan.n} elements, x has {n}")
        perm = plan.perm
    else:
        perm = _checked(plan, n, x.device)
    return _gather(x, perm).reshape(x.shape)


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
    return _gather(x, _checked(flat, R * LANES, x.device)).reshape(R, LANES)
