"""spmv_roofline_pct (layer "kernels"): the share of the card's roofline
reached by the program's planned SpMVs (``kernels.spmv_route.spmv_route``,
K1, and ``spmv_route_monoid``, K3), over all their calls in the window.

Numerator: the sum over calls of the least time (``roofline.least_s``) of
the compulsory bytes and the operations of one product by the cell's
matrix, worked out from the matrix (its shape and stored entries) and the
mix: indptr, indices and x read once, y written once, and the values read
once only where the mix's semiring needs them (``spmv_values``: min-plus
SSSP does, a pattern product such as PageRank does not).  Denominator: the
stream time between CUDA events recorded around the calls.  Nothing is
read from the program's plan, so the metric reads the same work whatever
implements the SpMV."""

from __future__ import annotations

from gbbench import graph, roofline


def call_bytes(run) -> int:
    """Compulsory bytes of one product y = A' x (the algorithms multiply by
    the matrix's CSC, so y has an entry per column of A), vectors and
    values in the configuration's value type."""
    nrows, ncols = run.shape
    vsize = graph.value_dtype(run.config).itemsize
    return roofline.spmv_bytes(
        ncols, nrows, run.nnz, vsize if run.traffic["spmv_values"] else 0,
        vsize)


def install(run):
    if not run.cuda:
        return None
    import torch
    from graphblas_tpu_torch.kernels import spmv_route
    least = roofline.least_s(call_bytes(run), roofline.spmv_ops(run.nnz))
    calls = []

    def make(fn):
        def spmv(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            y = fn(*a, **k)
            e.record()
            calls.append((s, e))
            return y
        return spmv

    hooked = [run.patch(spmv_route, name, make)
              for name in ("spmv_route", "spmv_route_monoid")]
    if not any(hooked):
        return None

    def read():
        if not calls:
            return None
        took = sum(s.elapsed_time(e) for s, e in calls) / 1e3
        return 100.0 * least * len(calls) / took
    return read
