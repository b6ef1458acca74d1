"""tc_sortreduce_ms (layer "spgemm"): milliseconds per triangle count in
the program's ``spgemm.sortreduce`` spans, the SpGEMM tier's expansion
and sort-reduce (SELL's pass 1, the fast tier's classes or the classic
tier's blocks): stream time between the spans' CUDA events
(``gbbench.tc.install_span``)."""

from __future__ import annotations

from gbbench import tc


def install(run):
    return tc.install_span(run, "spgemm.sortreduce")
