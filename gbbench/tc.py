"""Triangle counting's compulsory work, from the matrix's pattern alone,
and the reading of the program's SpGEMM spans, for the ``tc_*`` metrics.

``work`` counts what a count of the symmetric pattern needs whatever
implements it: the wedges of the pattern oriented from the lower
(degree, id) rank to the higher one, sum over k of c_k (c_k - 1) / 2
with c_k the neighbours of k ranked above it, one operation each (every
triangle is one such wedge closed by its third edge; ranking by degree
gives the fewest wedges of the usual orientations, as LAGraph's and
GAP's presorts do), and the bytes of L = tril(A, -1)'s int32 row
pointers and column ids read twice, as L and as L'.  Nothing is read
from the program's plan or tier."""

from __future__ import annotations

import torch

from . import roofline


def work(indptr: torch.Tensor, indices: torch.Tensor, n: int):
    """(bytes, wedges) of a count on the n x n symmetric pattern held by
    row as (indptr, indices)."""
    nnz = int(indices.numel())
    rows = torch.repeat_interleave(
        torch.arange(n, device=indptr.device),
        torch.diff(indptr.long()), output_size=nnz)
    cols = indices.long()
    off = rows != cols
    rows, cols = rows[off], cols[off]
    deg = torch.bincount(rows, minlength=n)
    order = torch.argsort(deg * n + torch.arange(n, device=deg.device))
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=deg.device)
    up = torch.bincount(rows[rank[cols] > rank[rows]], minlength=n)
    wedges = int((up * (up - 1) // 2).sum())
    nnz_l = int((cols < rows).sum())
    return 2 * roofline.INDEX_BYTES * (n + 1 + nnz_l), wedges


def install_span(run, name: str):
    """A reader of the milliseconds per algorithm call in the program's
    spans ``name``: their stream time between their CUDA events on a card
    (the count enqueues without waiting, so the host's time in a span
    would be its enqueue), their host time without events.  None where
    the program keeps no trace, dropped records, or opened no
    ``algorithms.triangle_count`` span (a program without these spans)."""
    from gbbench import program_trace
    config = program_trace.turn_on()
    if config is None:
        return None

    def ms(r):
        stream = r.stream_ms()
        return (r.end_ns - r.start_ns) / 1e6 if stream is None else stream

    def read():
        recs = config.trace_records()
        if config.trace_counters().get("trace.dropped") or not any(
                r.name == "algorithms.triangle_count" for r in recs):
            return None
        return sum(ms(r) for r in recs if r.name == name) / run.calls
    return read
