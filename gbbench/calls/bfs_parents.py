"""One call of the program's ``algorithms.bfs_parents(A, root)``, Graph500
kernel 2, from the specification's 64 search keys: distinct roots drawn
from the seed uniformly among the vertices with at least one edge, and a
65th, distinct from them, for the warm call.  The window cycles through
the 64 in order.  The answer is the dense int64 parent array, -1 where
the search does not reach.

A window call that takes longer than ``MAX_CALL_S`` stops the run: fewer
than five such calls fit the 51 s window, and three of them under the
traced run's profiler hold more events than its trace reduction gets
through.  The warm call, which carries A's first flip by column, has no
limit."""

from __future__ import annotations

import time

import torch

from gbbench import catalog, graph

ROOTS = 64        # the specification's search keys
MAX_CALL_S = 10.0


class Warm(int):
    """The warm call's root (a call with no time limit)."""


def inputs(edges, cfg: dict, seed: int):
    """(the window's roots, the warm call's root)."""
    gen = torch.Generator(device=edges.src.device)
    gen.manual_seed(catalog.derive(seed, "roots"))
    cand = torch.nonzero(graph.has_edges(edges, cfg)).reshape(-1)
    pick = torch.randperm(cand.numel(), generator=gen,
                          device=cand.device)[:ROOTS + 1]
    roots = cand[pick].tolist()
    return roots[:-1], Warm(roots[-1])


def call(A, root: int, kwargs: dict):
    from graphblas_tpu_torch import algorithms
    t = time.perf_counter()
    v, p = algorithms.bfs_parents(A, root, **kwargs).to_dense_1d()
    took = time.perf_counter() - t
    if not isinstance(root, Warm) and took > MAX_CALL_S:
        raise RuntimeError(
            f"bfs_parents took {took:.1f} s, more than the cell's "
            f"{MAX_CALL_S} s a call")
    return torch.where(p, v, torch.full_like(v, -1))
