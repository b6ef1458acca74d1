"""bfsp_spmm_ms (layer "op layer"): milliseconds per BFS parent tree in
the program's ``mxm.spmm`` spans, the sparse-times-bitmap product each
level's masked MIN_FIRSTJ ``vxm`` runs (the whole matrix expanded, the
mask applied after): stream time between the spans' CUDA events
(``gbbench.bfs.install_span``)."""

from __future__ import annotations

from gbbench import bfs


def install(run):
    return bfs.install_span(run, "mxm.spmm")
