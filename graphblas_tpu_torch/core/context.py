"""Execution contexts — the GxB_Context analog (counterpart of
``graphblas_tpu.core.context``; reference: Source/GB_Context.c, a
per-user-thread object holding nthreads_max/chunk, engaged through
OpenMP threadprivate storage).

Here the resource a context governs is the device that
``device_put_ctx`` places tensors on.  Same shape: thread-local,
engage/disengage, nestable with ``with``.  As in the JAX package, nothing
reads the context but ``device_put_ctx``; so the JAX context's ``chunk``
and ``pallas_enabled``, which no op reads, have no counterpart here (the
``kernels_enabled`` option switches the kernels).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import torch


_tls = threading.local()


@dataclasses.dataclass
class Context:
    """Per-thread execution context (GxB_Context_new/engage/disengage)."""

    device: Any = None          # torch device (None: leave tensors be)
    name: str = ""

    def engage(self) -> "Context":
        _tls.ctx = self
        return self

    def disengage(self) -> None:
        if getattr(_tls, "ctx", None) is self:
            _tls.ctx = None

    def __enter__(self):
        self._prev = getattr(_tls, "ctx", None)
        return self.engage()

    def __exit__(self, *exc):
        _tls.ctx = self._prev
        return False


def current() -> Context:
    """This thread's engaged context, else a "world" context that names
    no device."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        ctx = Context(name="world")
        _tls.ctx = ctx
    return ctx


def device_put_ctx(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the engaged context's device (as it is when it names
    none)."""
    ctx = current()
    return x.to(ctx.device) if ctx.device is not None else x
