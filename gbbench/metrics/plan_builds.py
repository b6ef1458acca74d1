"""plan_builds (layer "spmv plan"): SpMV plans built per algorithm call,
by the program's own counter ``spmv_plan.builds`` (one a call of
``kernels.spmv_route.build_plan``); plan-cache lookups that found their
plan do not count."""

from __future__ import annotations

from gbbench import program_trace


def install(run):
    return program_trace.install_counter(run, "spmv_plan.builds")
