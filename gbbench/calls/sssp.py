"""One call of the program's ``algorithms.sssp(A, root, **kwargs)``, from
roots drawn from the seed among the vertices with edges (Graph500 kernel
3); the answer is the distance vector."""

from __future__ import annotations

import torch

from gbbench import catalog, graph

ROOTS = 4096      # roots drawn per run; the window cycles through them


def inputs(edges, cfg: dict, seed: int):
    """(the window's roots, the warm call's root)."""
    gen = torch.Generator(device=edges.src.device)
    gen.manual_seed(catalog.derive(seed, "roots"))
    cand = torch.nonzero(graph.has_edges(edges, cfg)).reshape(-1)
    pick = torch.randint(cand.numel(), (ROOTS + 1,), generator=gen,
                         device=cand.device)
    roots = cand[pick].tolist()
    return roots[:-1], roots[-1]


def call(A, root: int, kwargs: dict):
    from graphblas_tpu_torch import algorithms
    return algorithms.sssp(A, root, **kwargs)
