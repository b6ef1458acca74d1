"""plan_fetch_ms (layer "spmv plan"): host milliseconds per algorithm
call in the program's own ``spmv_plan.fetch`` span, inside
``kernels.spmv_route.build_plan``: the CSR pointer array copied to the
host and widened to int64, with any wait for the card's queued work."""

from __future__ import annotations

from gbbench import program_trace


def install(run):
    return program_trace.install_span(run, "spmv_plan.fetch")
