"""tc_roofline_pct (layer "kernels"): the share of the card's roofline
reached by the program's triangle counts, over all their calls in the
window.

Numerator: the calls times the least time (``roofline.least_s``) of one
count's compulsory bytes and wedges (``gbbench.tc.work``), worked out
once from the matrix's pattern before the first call's events, outside
the timed stretch.  Denominator: the stream time between CUDA events
recorded around each call of ``algorithms.triangle_count``."""

from __future__ import annotations

from gbbench import roofline, tc


def install(run):
    if not run.cuda:
        return None
    import torch
    from graphblas_tpu_torch import algorithms
    least = []
    calls = []

    def make(fn):
        def triangle_count(A, *a, **k):
            if not least:
                run.sync()
                nbytes, wedges = tc.work(A.indptr, A.indices, A.nrows)
                least.append(roofline.least_s(nbytes, wedges))
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(A, *a, **k)
            e.record()
            calls.append((s, e))
            return out
        return triangle_count

    if not run.patch(algorithms, "triangle_count", make):
        return None

    def read():
        if not calls:
            return None
        took = sum(s.elapsed_time(e) for s, e in calls) / 1e3
        return 100.0 * least[0] * len(calls) / took
    return read
