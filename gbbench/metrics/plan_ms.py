"""plan_ms (layer "spmv plan"): host milliseconds inside the program's
``kernels.spmv_route.build_plan`` per algorithm call, each timed from
entry (after the card has drained the work queued before it, so that the
reorient's kernels are not counted again) to return."""

from __future__ import annotations

import time


def install(run):
    from graphblas_tpu_torch.kernels import spmv_route
    spent = [0.0]

    def make(fn):
        def build_plan(*a, **k):
            run.sync()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[0] += time.perf_counter() - t0
        return build_plan

    if not run.patch(spmv_route, "build_plan", make):
        return None
    return lambda: spent[0] * 1e3 / run.calls
