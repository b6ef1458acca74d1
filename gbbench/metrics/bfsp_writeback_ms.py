"""bfsp_writeback_ms (layer "op layer"): milliseconds per BFS parent tree
in the program's ``masker.writeback`` spans: the complemented structural
mask with replace that each level's ``vxm`` applies to its product, and
the eWise add's write-back: stream time between the spans' CUDA events
(``gbbench.bfs.install_span``)."""

from __future__ import annotations

from gbbench import bfs


def install(run):
    return bfs.install_span(run, "masker.writeback")
