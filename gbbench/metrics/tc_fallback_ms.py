"""tc_fallback_ms (layer "spgemm"): milliseconds per triangle count in
the program's ``spgemm.fallback`` spans, the rows too long for the
tier's sort tiles (the hub rows) counted on the classic path: stream time
between the spans' CUDA events (``gbbench.tc.install_span``)."""

from __future__ import annotations

from gbbench import tc


def install(run):
    return tc.install_span(run, "spgemm.fallback")
