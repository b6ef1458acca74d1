"""Breadth-first search parent tree in plain torch, from the generated
edges (Graph500 kernel 2).

Top-down and level-synchronous, independent of the program's masked
MIN_FIRSTJ vxm: each level the edges of the frontier's vertices are
expanded (in blocks of at most ``CHUNK`` edges, so that a level fits
beside whatever else is held), and each vertex that one of them ends at
and that no earlier level reached takes the least frontier vertex as its
parent, by ``scatter_reduce("amin")`` over the frontier's ids carried in
``dtype``; the root is its own parent.  The adjacency is this file's own:
both directions of every generated edge, grouped by source (self loops
are already dropped where the configuration says so; duplicates change
no parent).  float64 holds every vertex id exactly and gives the
reference; bfloat16, whose 8-bit significand rounds ids past 256, is the
lower-precision control.  Imports nothing of the program."""

from __future__ import annotations

import torch

CHUNK = 1 << 26


def prepare(edges, cfg: dict, params: dict, dtype) -> dict:
    rows, cols = edges.src, edges.dst
    if cfg["symmetric"]:
        rows, cols = torch.cat([rows, cols]), torch.cat([cols, rows])
    order = torch.argsort(rows)
    indptr = torch.zeros(edges.n + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(torch.bincount(rows.long(), minlength=edges.n), 0,
                 out=indptr[1:])
    del rows
    return {"n": edges.n, "indptr": indptr, "nbr": cols[order]}


def _repeat_arange(starts, lens, total: int):
    off = torch.cumsum(lens, 0) - lens
    return torch.repeat_interleave(starts - off, lens, output_size=total) + \
        torch.arange(total, dtype=starts.dtype, device=starts.device)


def solve(state: dict, root: int, params: dict, dtype) -> torch.Tensor:
    """int64 parents from ``root`` (-1 where unreached), the frontier's
    ids carried in ``dtype``."""
    n, indptr, nbr = state["n"], state["indptr"], state["nbr"]
    dev = nbr.device
    root = int(root)
    parent = torch.full((n,), -1, dtype=torch.int64, device=dev)
    parent.narrow(0, root, 1).fill_(root)
    seen = parent >= 0
    front = torch.tensor([root], dtype=torch.int64, device=dev)
    while front.numel():
        best = torch.full((n,), float("inf"), dtype=dtype, device=dev)
        starts = indptr[front]
        lens = indptr[front + 1] - starts
        cum = torch.cumsum(lens, 0)
        total = int(cum[-1])
        cuts = torch.searchsorted(
            cum, torch.arange(1, total // CHUNK + 1, device=dev) * CHUNK,
            right=True).tolist() + [front.numel()]
        a = 0
        for b in cuts:
            if b <= a:
                continue
            ln = lens[a:b]
            k = int(ln.sum())
            e = _repeat_arange(starts[a:b], ln, k)
            src = torch.repeat_interleave(front[a:b], ln, output_size=k)
            best.scatter_reduce_(0, nbr[e].long(), src.to(dtype), "amin")
            a = b
        new = torch.isfinite(best) & ~seen
        parent = torch.where(new, best.to(torch.int64), parent)
        seen |= new
        front = torch.nonzero(new).reshape(-1)
    return parent


def compare(got: torch.Tensor, want: torch.Tensor, root) -> dict:
    """The vertices whose parent differs (an unreached -1 included), and
    the vertices reached on one side only."""
    got = got.to(device=want.device, dtype=torch.int64)
    return {"parent_mismatch": float((got != want).sum()),
            "reach_mismatch": float(((got >= 0) != (want >= 0)).sum())}
