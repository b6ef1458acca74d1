"""Triangle count in plain torch, from the generated edges.

Independent of the program's formulation (sum((L L') .* L) with
L = tril(A)): each undirected edge (self loops dropped, duplicates merged)
is oriented from its lower (degree, id) rank to its higher one, the
wedges v -> a, v -> b with a ranked below b are enumerated in blocks of at
most ``CHUNK``, and each wedge is closed where the edge a -> b exists,
found by ``searchsorted`` on the sorted int64 keys of the oriented edges.
Every triangle is one wedge at its lowest-ranked vertex, so the closed
wedges are the triangles.  The block counts are summed in ``dtype``:
float64 is exact below 2^53 and gives the reference; bfloat16 and
float32 are the lower-precision controls.  Imports nothing of the
program."""

from __future__ import annotations

import torch

CHUNK = 1 << 26


def prepare(edges, cfg: dict, params: dict, dtype) -> dict:
    n = edges.n
    a, b = edges.src.long(), edges.dst.long()
    lo, hi = torch.minimum(a, b), torch.maximum(a, b)
    key = torch.unique((lo * n + hi)[lo != hi])      # each edge once
    del a, b, lo, hi
    u, v = key // n, key % n
    deg = torch.bincount(u, minlength=n) + torch.bincount(v, minlength=n)
    order = torch.argsort(deg * n + torch.arange(n, device=deg.device))
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=deg.device)
    ru, rv = rank[u], rank[v]
    del u, v, key, deg, order, rank
    keys = torch.sort(torch.minimum(ru, rv) * n + torch.maximum(ru, rv)
                      ).values                       # by (tail, head)
    src = keys // n
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(torch.bincount(src, minlength=n), 0, out=indptr[1:])
    return {"n": n, "keys": keys, "src": src, "dst": keys % n,
            "indptr": indptr}


def _repeat_arange(starts, lens, total: int):
    off = torch.cumsum(lens, 0) - lens
    return torch.repeat_interleave(starts - off, lens, output_size=total) + \
        torch.arange(total, dtype=starts.dtype, device=starts.device)


def solve(state: dict, key, params: dict, dtype) -> float:
    """The number of triangles, summed in ``dtype``."""
    n, keys, src, dst = state["n"], state["keys"], state["src"], state["dst"]
    dev = keys.device
    E = keys.numel()
    total = torch.zeros((), dtype=dtype, device=dev)
    if E == 0:
        return 0.0
    first = torch.arange(E, device=dev)
    # wedges of edge e = (v, a): the edges of v after e, each v -> b
    per = state["indptr"][src + 1] - 1 - first
    cum = torch.cumsum(per, 0)
    step = CHUNK - int(per.max())           # a block ends within CHUNK
    cuts = torch.searchsorted(
        cum, torch.arange(1, int(cum[-1]) // step + 1, device=dev) * step,
        right=True).tolist() + [E]
    s = 0
    for t in cuts:
        if t <= s:
            continue
        lens = per[s:t]
        k = int(lens.sum())
        if k:
            e = torch.repeat_interleave(first[s:t], lens, output_size=k)
            q = _repeat_arange(first[s:t] + 1, lens, k)
            closing = dst[e] * n + dst[q]
            pos = torch.searchsorted(keys, closing).clamp_(max=E - 1)
            total = total + (keys[pos] == closing).sum().to(dtype)
        s = t
    return float(total)


def compare(got, want, key) -> dict:
    """How far the count lies from the reference's."""
    return {"count_gap": abs(float(got) - float(want))}
