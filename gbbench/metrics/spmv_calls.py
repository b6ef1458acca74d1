"""spmv_calls (layer "algorithms"): calls of the program's planned SpMVs
(``kernels.spmv_route.spmv_route`` and ``spmv_route_monoid``) per
algorithm call, counted by the benchmark's own wrapper."""

from __future__ import annotations


def install(run):
    from graphblas_tpu_torch.kernels import spmv_route
    count = [0]

    def make(fn):
        def spmv(*a, **k):
            count[0] += 1
            return fn(*a, **k)
        return spmv

    hooked = [run.patch(spmv_route, name, make)
              for name in ("spmv_route", "spmv_route_monoid")]
    if not any(hooked):
        return None
    return lambda: count[0] / run.calls
