"""One call of the program's ``algorithms.triangle_count(A)`` on the whole
graph: every call is alike and gets nothing besides the matrix; the
answer is the count.  A caller counting again on the unchanged graph
finds L, L' and the SpGEMM's prep in the program's own caches, formed by
the warm call.

A window call that takes longer than ``MAX_CALL_S`` stops the run: fewer
than five such calls fit the 51 s window, and three of them under the
traced run's profiler hold more events than its trace reduction gets
through (a program that counts at scale 20 in ~25 s a call, with some
50,000 launches and host waits, went past 385 s there).  The warm call,
which carries the kernels' first build and L's formation, has no
limit."""

from __future__ import annotations

import time

MAX_CALL_S = 10.0
WARM = "warm"


def inputs(edges, cfg: dict, seed: int):
    """(the window's inputs, the warm call's input): none."""
    return [None], WARM


def call(A, key, kwargs: dict):
    from graphblas_tpu_torch import algorithms
    t = time.perf_counter()
    count = int(algorithms.triangle_count(A, **kwargs))
    took = time.perf_counter() - t
    if key != WARM and took > MAX_CALL_S:
        raise RuntimeError(
            f"triangle_count took {took:.1f} s, more than the cell's "
            f"{MAX_CALL_S} s a call")
    return count
