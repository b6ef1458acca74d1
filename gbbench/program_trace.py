"""The program's own spans and counters, for the per-layer metrics that
read them: ``graphblas_tpu_torch.core.config``'s ``trace`` option, its
``Span`` records (``time.time_ns()`` stamps) and its counters.  Where the
program has no such facility the metrics have nothing to read."""

from __future__ import annotations


def turn_on():
    """Clear the program's records and counters and turn its ``trace``
    option on; the program's config module, or None where it keeps no
    trace."""
    from graphblas_tpu_torch.core import config
    if not hasattr(config.GLOBAL, "trace") or not all(
            hasattr(config, f) for f in ("trace_records", "trace_counters",
                                         "trace_reset")):
        return None
    config.trace_reset()
    config.set_option("trace", True)
    return config


def span_ms(config, name: str):
    """Host milliseconds in the kept spans named ``name``; None where the
    program dropped records (the sum would miss some)."""
    if config.trace_counters().get("trace.dropped"):
        return None
    return sum(r.end_ns - r.start_ns for r in config.trace_records()
               if r.name == name) / 1e6


def install_span(run, name: str):
    """A reader of the span ``name``'s host milliseconds per algorithm
    call, or None."""
    config = turn_on()
    if config is None:
        return None

    def read():
        ms = span_ms(config, name)
        return None if ms is None else ms / run.calls
    return read


def install_counter(run, name: str):
    """A reader of the counter ``name`` per algorithm call, or None."""
    config = turn_on()
    if config is None:
        return None
    return lambda: config.trace_counters().get(name, 0) / run.calls
