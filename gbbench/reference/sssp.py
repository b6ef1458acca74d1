"""Single-source shortest paths in plain torch, from the generated edges.

Bellman-Ford over a frontier: each round, the vertices whose distance fell
in the last round relax all their edges (processed in blocks of at most
``CHUNK`` edges, so that a round fits beside whatever else is held).  The
adjacency is this file's own: both directions of every generated edge,
grouped by source, duplicates kept (min-plus takes the least of them, which
is what a build with ``dup="min"`` stores).  ``dtype`` float64 gives the
reference; bfloat16 the lower-precision control.  Imports nothing of the
program."""

from __future__ import annotations

import torch

CHUNK = 1 << 26


def prepare(edges, cfg: dict, params: dict, dtype) -> dict:
    rows, cols, w = edges.src, edges.dst, edges.w
    if cfg["symmetric"]:
        rows, cols, w = (torch.cat([rows, cols]), torch.cat([cols, rows]),
                         torch.cat([w, w]))
    order = torch.argsort(rows)
    indptr = torch.zeros(edges.n + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(torch.bincount(rows.long(), minlength=edges.n), 0,
                 out=indptr[1:])
    del rows
    return {"n": edges.n, "indptr": indptr, "nbr": cols[order],
            "w": w[order].to(dtype)}


def _repeat_arange(starts, lens, total: int):
    off = torch.cumsum(lens, 0) - lens
    return torch.repeat_interleave(starts - off, lens, output_size=total) + \
        torch.arange(total, dtype=starts.dtype, device=starts.device)


def solve(state: dict, root: int, params: dict, dtype) -> torch.Tensor:
    """float64 distances from ``root`` (inf where unreached), computed in
    ``dtype``."""
    n, indptr, nbr, w = state["n"], state["indptr"], state["nbr"], state["w"]
    d = torch.full((n,), float("inf"), dtype=dtype, device=w.device)
    d[root] = 0
    front = torch.tensor([root], dtype=torch.int64, device=w.device)
    while front.numel():
        nd = d.clone()
        starts = indptr[front]
        lens = indptr[front + 1] - starts
        cum = torch.cumsum(lens, 0)
        total = int(cum[-1])
        cuts = torch.searchsorted(
            cum, torch.arange(1, total // CHUNK + 1, device=w.device) * CHUNK,
            right=True).tolist() + [front.numel()]
        a = 0
        for b in cuts:
            if b <= a:
                continue
            ln = lens[a:b]
            k = int(ln.sum())
            e = _repeat_arange(starts[a:b], ln, k)
            src = torch.repeat_interleave(front[a:b], ln, output_size=k)
            nd.scatter_reduce_(0, nbr[e].long(), d[src] + w[e], "amin")
            a = b
        front = torch.nonzero(nd < d).reshape(-1)
        d = nd
    return d.to(torch.float64)


def compare(got: torch.Tensor, want: torch.Tensor, root) -> dict:
    """The widest relative gap of a reached vertex's distance (absolute
    where the reference's distance is 0), and the number of vertices
    reached on one side only."""
    got = got.to(torch.float64)
    reach = torch.isfinite(want)
    mismatch = int((torch.isfinite(got) != reach).sum())
    g, w = got[reach], want[reach]
    gap = (g - w).abs()
    rel = torch.nan_to_num(torch.where(w > 0, gap / w, gap), nan=float("inf"))
    return {"max_rel_gap": float(rel.max()) if rel.numel() else 0.0,
            "reach_mismatch": float(mismatch)}
