"""Global runtime state + burble tracing (counterpart of
``graphblas_tpu.core.config``; reference: Source/GB_Global.c, GB_init.c).

``kernels_enabled`` is the counterpart of the JAX package's
``pallas_enabled``: with it off every op runs its plain torch version, on
any device.  ``burble`` replicates the reference's GBURBLE diagnostics:
every op logs the method it chose.  ``device`` is where constructors put
their tensors when the caller names no device: the card by default;
``set_option("device", "cpu")`` asks for the CPU.

``timed`` is the program's span and ``count`` its counter.  A span
always adds its host seconds to ``GLOBAL.timing``; with the ``trace``
option on it also keeps a record (``Span``: name, ``time.time_ns()``
start and end, the span that opened it, the root span of its call) and
counters count.  ``trace_records``, ``trace_counters`` and
``trace_reset`` read and clear them.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import itertools
import os
import sys
import threading
import time
from typing import Callable

import torch


@dataclasses.dataclass
class _Global:
    initialized: bool = False
    # blocking (ops finalize pending work eagerly) vs nonblocking.
    blocking: bool = False
    burble: bool = False
    printf: Callable[[str], None] = lambda s: print(s, file=sys.stderr)
    # format auto-switch thresholds (reference: GB_Global.c:124-141).
    bitmap_switch: float = 0.10   # nvals/(nrows*ncols) above which -> bitmap
    hyper_switch: float = 1.0 / 16.0  # nvec_nonempty/nvec below which -> hyper
    # default orientation for new matrices ('row' == CSR, the reference
    # default; Source/GB_init.c).
    format_default: str = "row"
    # hand-written CUDA kernels on/off; off runs the plain torch versions.
    kernels_enabled: bool = True
    # device of new tensors when a constructor is given none
    device: str = "cuda"
    # host seconds by key, fed by ``timed`` (reference: GB_Global.timing)
    timing: dict = dataclasses.field(default_factory=dict)
    # span records and counters kept (``trace_records``/``trace_counters``)
    trace: bool = False


GLOBAL = _Global()


def default_device(device=None) -> torch.device:
    """``device``, or the ``device`` option when it is None.  A CUDA
    device raises where torch sees no card: nothing lands on the CPU
    unless the caller asks for it."""
    dev = torch.device(GLOBAL.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "graphblas_tpu_torch: no CUDA card; pass device='cpu' or "
            "set_option('device', 'cpu') to run on the CPU")
    return dev


def init(mode: str = "nonblocking") -> None:
    """GrB_init (reference: Source/GB_init.c:60-197)."""
    GLOBAL.initialized = True
    GLOBAL.blocking = (mode == "blocking")
    if os.environ.get("GB_BURBLE"):
        GLOBAL.burble = True


def finalize() -> None:
    """GrB_finalize."""
    GLOBAL.initialized = False


def set_option(name: str, value) -> None:
    """GrB_set(GrB_GLOBAL, ...) analog."""
    if not hasattr(GLOBAL, name):
        raise KeyError(f"unknown global option {name!r}")
    setattr(GLOBAL, name, value)


def get_option(name: str):
    """GrB_get(GrB_GLOBAL, ...) analog."""
    return getattr(GLOBAL, name)


def burble(msg: str, *args) -> None:
    if GLOBAL.burble:
        GLOBAL.printf("[GB] " + (msg % args if args else msg))


TRACE_CAP = 1 << 16    # span records kept; past it the oldest are dropped


@dataclasses.dataclass(eq=False, slots=True)
class Span:
    """One closed span.  ``start_ns``/``end_ns`` are ``time.time_ns()``
    stamps, the Unix-epoch clock torch.profiler stamps its events in (a
    trace's time is ``ns - trace_start_ns``).  ``parent`` is the id of
    the span open around it in its thread (None for a root), ``root`` the
    id of the outermost one.  ``events``: CUDA events recorded on the
    device's current stream at the two ends, for spans given a card."""

    name: str
    id: int
    parent: int | None
    root: int
    start_ns: int
    end_ns: int = 0
    events: tuple | None = None

    def stream_ms(self):
        """Stream milliseconds between the span's CUDA events (None
        without them); the card must have passed the second one."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])


class _Open(threading.local):
    def __init__(self):
        self.spans = []


class _Trace:
    """What the spans and counters keep while ``trace`` is on."""

    def __init__(self):
        self.lock = threading.Lock()
        self.records = collections.deque(maxlen=TRACE_CAP)
        self.counters = {}
        self.ids = itertools.count(1)
        self.open = _Open()

    def begin(self, name: str, device) -> Span:
        stack = self.open.spans
        sid = next(self.ids)
        up = stack[-1] if stack else None
        span = Span(name, sid, up.id if up else None,
                    up.root if up else sid, time.time_ns())
        if device is not None and torch.device(device).type == "cuda":
            span.events = (_event(device),)
        stack.append(span)
        return span

    def end(self, span: Span, device) -> None:
        if span.events is not None:
            span.events += (_event(device),)
        span.end_ns = time.time_ns()
        stack = self.open.spans
        if stack and stack[-1] is span:
            stack.pop()
        with self.lock:
            if len(self.records) == TRACE_CAP:
                self.counters["trace.dropped"] = \
                    self.counters.get("trace.dropped", 0) + 1
            self.records.append(span)

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n


_TRACE = _Trace()


def _event(device):
    """A timing CUDA event recorded on ``device``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class timed:
    """Context manager adding its block's host seconds to
    ``GLOBAL.timing[key]`` (the reference's GB_Global.timing): the
    program's span.  While the ``trace`` option is on it also keeps a
    ``Span`` record of the block, with CUDA events at its two ends when
    ``device`` is a card.  Also a decorator (a fresh span each call)."""

    __slots__ = ("key", "device", "t0", "_span")

    def __init__(self, key: str, device=None):
        self.key = key
        self.device = device

    def __enter__(self):
        self._span = _TRACE.begin(self.key, self.device) if GLOBAL.trace \
            else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        GLOBAL.timing[self.key] = GLOBAL.timing.get(self.key, 0.0) + (
            time.perf_counter() - self.t0)
        if self._span is not None:
            _TRACE.end(self._span, self.device)
        return False

    def __call__(self, fn):
        key, device = self.key, self.device

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with timed(key, device):
                return fn(*args, **kwargs)
        return spanned


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while ``trace`` is on."""
    if GLOBAL.trace:
        _TRACE.count(name, n)


def blocking_copy(t, device) -> torch.Tensor:
    """``t`` (a tensor or numpy array) copied to ``device``, the host
    waiting until it is there: a device value read on the host, or a
    pageable upload.  Every call is one ``host_syncs``."""
    count("host_syncs")
    return torch.as_tensor(t).to(device)


def trace_records() -> list:
    """The kept ``Span`` records, oldest first (at most ``TRACE_CAP``;
    ``trace_counters()["trace.dropped"]`` counts those dropped)."""
    with _TRACE.lock:
        return list(_TRACE.records)


def trace_counters() -> dict:
    """The counters, by name."""
    with _TRACE.lock:
        return dict(_TRACE.counters)


def trace_reset() -> None:
    """Forget every kept record and counter."""
    with _TRACE.lock:
        _TRACE.records.clear()
        _TRACE.counters.clear()
