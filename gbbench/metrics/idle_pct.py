"""idle_pct (layer "device"): the share of the traced stretch of the
window (a few whole calls under torch.profiler) in which no operation of
the device ran: 100 * (1 - busy / stretch), busy being the union of the
device's own events."""

from __future__ import annotations


def install(run):
    if not run.cuda:
        return None

    def read():
        t = run.trace
        if t is None or t["busy_s"] <= 0:
            return None
        return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
    return read
