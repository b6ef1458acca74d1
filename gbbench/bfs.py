"""Graph500 kernel 2's compulsory work, from the pattern and the root
alone, and the reading of the program's op-layer spans and counters, for
the ``bfsp_*`` metrics.

A search from a root reaches the root's connected component.  Whatever
implements it (push, pull, an early exit, a sparse result) writes one
int64 parent for each reached vertex and reads, for each of them but the
root, at least the int32 column id of the edge it was reached by: 12
bytes a reached vertex, less 4, at the HBM rate, with no operations
counted (``roofline.least_s``).  The components are worked out here by
min-label propagation over the matrix's own row pointers and column ids;
nothing is read from the program's counters."""

from __future__ import annotations

import torch

from . import roofline

ROOT_SPAN = "algorithms.bfs_parents"
PARENT_BYTES = 8
CHUNK = 1 << 27


def components(indptr: torch.Tensor, indices: torch.Tensor,
               n: int) -> torch.Tensor:
    """int64 label of each vertex of the symmetric n x n pattern held by
    row: the least vertex id of its connected component."""
    dev = indptr.device
    nnz = int(indices.numel())
    rows = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int32, device=dev),
        torch.diff(indptr.long()), output_size=nnz)
    labels = torch.arange(n, device=dev)
    while True:
        new = labels.clone()
        for s in range(0, nnz, CHUNK):
            new.scatter_reduce_(0, rows[s:s + CHUNK].long(),
                                labels[indices[s:s + CHUNK].long()], "amin")
        new = new[new]                       # shortcut to the label's label
        if torch.equal(new, labels):
            return labels
        labels = new


def least_s(reached: int) -> float:
    """Seconds the card needs at least for a search that reaches
    ``reached`` vertices."""
    nbytes = (PARENT_BYTES + roofline.INDEX_BYTES) * reached \
        - roofline.INDEX_BYTES
    return roofline.least_s(nbytes, 0)


def install_reader(run, read_total):
    """A reader of ``read_total(config)`` per algorithm call, turning the
    program's trace on; None where the program keeps no trace, and the
    reader's value None where records were dropped or no
    ``algorithms.bfs_parents`` span was opened (a program without these
    spans and counters)."""
    from gbbench import program_trace
    config = program_trace.turn_on()
    if config is None:
        return None

    def read():
        if config.trace_counters().get("trace.dropped") or not any(
                r.name == ROOT_SPAN for r in config.trace_records()):
            return None
        return read_total(config) / run.calls
    return read


def install_span(run, name: str):
    """Milliseconds per call in the program's spans ``name``: stream time
    between their CUDA events on a card, host time without events."""
    def ms(r):
        stream = r.stream_ms()
        return (r.end_ns - r.start_ns) / 1e6 if stream is None else stream

    return install_reader(run, lambda config: sum(
        ms(r) for r in config.trace_records() if r.name == name))


def install_counter(run, name: str):
    """The program's counter ``name`` per call."""
    return install_reader(
        run, lambda config: config.trace_counters().get(name, 0))
