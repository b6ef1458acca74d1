"""PageRank in plain torch, from the generated edges.

Frozen from ``chip_smoke.py``'s ``pagerank_ref`` (fp64 numpy power
iteration) and rewritten in torch: the pattern is this file's own (both
directions of every generated edge, duplicates merged, self loops already
dropped), each vertex sends r / out-degree along its edges, the rank of
vertices without edges is spread evenly, and the loop stops after the step
whose L1 change is at most ``tol`` or after ``max_iter`` steps, as the
program's parameters say.  ``dtype`` float64 gives the reference; bfloat16
the lower-precision control.  Imports nothing of the program."""

from __future__ import annotations

import torch

CHUNK = 1 << 26


def prepare(edges, cfg: dict, params: dict, dtype) -> dict:
    n = edges.n
    rows, cols = edges.src, edges.dst
    if cfg["symmetric"]:
        rows, cols = torch.cat([rows, cols]), torch.cat([cols, rows])
    key = torch.unique(rows.long() * n + cols.long())
    del rows, cols
    src, dst = (key // n).to(torch.int32), (key % n).to(torch.int32)
    return {"n": n, "src": src, "dst": dst,
            "deg": torch.bincount(src.long(), minlength=n)}


def solve(state: dict, key, params: dict, dtype) -> torch.Tensor:
    """float64 ranks computed in ``dtype``."""
    n, src, dst, deg = state["n"], state["src"], state["dst"], state["deg"]
    damping, tol = params["damping"], params["tol"]
    has = deg > 0
    safe = torch.where(has, deg, torch.ones_like(deg)).to(dtype)
    r = torch.full((n,), 1.0 / n, dtype=dtype, device=deg.device)
    it, delta = 0, float("inf")
    while it < params["max_iter"] and delta > tol:
        w = r / safe
        rn = torch.zeros_like(r)
        for a in range(0, src.numel(), CHUNK):
            rn.index_add_(0, dst[a:a + CHUNK].long(),
                          w[src[a:a + CHUNK].long()])
        dangling = torch.where(has, torch.zeros_like(r), r).sum()
        rn = damping * (rn + dangling / n) + (1.0 - damping) / n
        delta = float((rn - r).abs().sum())
        r = rn
        it += 1
    return r.to(torch.float64)


def compare(got: torch.Tensor, want: torch.Tensor, key) -> dict:
    """The widest relative gap of a vertex's rank (every rank is at least
    (1 - damping) / n > 0)."""
    rel = (got.to(torch.float64) - want).abs() / want
    return {"max_rel_gap": float(torch.nan_to_num(rel, nan=float("inf"))
                                 .max())}
