"""bfsp_roofline_pct (layer "kernels"): the share of the card's roofline
reached by the program's BFS parent trees, over all their calls in the
window.

Numerator: each call's least time (``gbbench.bfs.least_s``) from the
size of its root's connected component, the components worked out once
from the matrix's pattern before the first call's events, outside the
timed stretch.  Denominator: the stream time between CUDA events
recorded around each call of ``algorithms.bfs_parents``."""

from __future__ import annotations

from gbbench import bfs


def install(run):
    if not run.cuda:
        return None
    import torch
    from graphblas_tpu_torch import algorithms
    sizes = {}
    calls = []

    def make(fn):
        def bfs_parents(A, source, *a, **k):
            if not sizes:
                run.sync()
                labels = bfs.components(A.indptr, A.indices, A.nrows)
                sizes["labels"] = labels
                sizes["count"] = torch.bincount(labels, minlength=A.nrows)
                run.sync()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(A, source, *a, **k)
            e.record()
            calls.append((s, e, int(source)))
            return out
        return bfs_parents

    if not run.patch(algorithms, "bfs_parents", make):
        return None

    def read():
        if not calls:
            return None
        roots = torch.tensor([r for _, _, r in calls],
                             device=sizes["labels"].device)
        reached = sizes["count"][sizes["labels"][roots]].tolist()
        took = sum(s.elapsed_time(e) for s, e, _ in calls) / 1e3
        return 100.0 * sum(bfs.least_s(r) for r in reached) / took
    return read
