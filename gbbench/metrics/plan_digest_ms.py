"""plan_digest_ms (layer "spmv plan"): host milliseconds per algorithm
call in the program's own ``spmv_plan.digest`` span, inside
``kernels.spmv_route.build_plan``: the sha256 of the int64 pointer array
that the plan keeps to recognise its matrix."""

from __future__ import annotations

from gbbench import program_trace


def install(run):
    return program_trace.install_span(run, "spmv_plan.digest")
