"""reorient_ms (layer "object model"): stream milliseconds between CUDA
events recorded around the program's ``core.convert.convert`` (the CSR ->
CSC reorient every fused algorithm asks for), per algorithm call."""

from __future__ import annotations


def install(run):
    if not run.cuda:
        return None
    import torch
    from graphblas_tpu_torch.core import convert
    pairs = []

    def make(fn):
        def convert_(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            pairs.append((s, e))
            return out
        return convert_

    if not run.patch(convert, "convert", make):
        return None
    return lambda: sum(s.elapsed_time(e) for s, e in pairs) / run.calls
