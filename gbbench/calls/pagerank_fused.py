"""One call of the program's ``algorithms.pagerank_fused(A, **kwargs)`` on
the whole graph: every call is alike and gets nothing besides the matrix;
the answer is the rank vector."""

from __future__ import annotations


def inputs(edges, cfg: dict, seed: int):
    """(the window's inputs, the warm call's input): none."""
    return [None], None


def call(A, key, kwargs: dict):
    from graphblas_tpu_torch import algorithms
    ranks, _ = algorithms.pagerank_fused(A, **kwargs)
    return ranks
