"""Spans around calls into the program, and the reading of a profiler trace.

``Patches`` rebinds a module attribute of the program to a wrapper for the
length of a traced run and puts the original back afterwards; no program
file changes.  ``Stretch`` runs ``torch.profiler`` over a few calls of the
window and reduces its trace to the device's busy time (the union of the
device's own events, copied from ``chip_smoke.py``'s ``_busy_s``), the
device operations that took most time, and the idle gaps by what the host
was doing when they happened.
"""

from __future__ import annotations

import bisect

LABEL = "gbbench:"          # prefix of the benchmark's own profiler labels
TOP = 10                    # entries of each breakdown list
NAME_CHARS = 120


class Patches:
    """Module attributes rebound to wrappers, undone in reverse order."""

    def __init__(self):
        self._undo = []

    def wrap(self, module, attr: str, make) -> bool:
        """Rebind ``module.attr`` to ``make(current)``, under a profiler
        label ``gbbench:<module>.<attr>``.  False where the program has no
        such attribute (the metric then has nothing to read)."""
        import torch
        fn = getattr(module, attr, None)
        if fn is None:
            return False
        inner = make(fn)
        label = f"{LABEL}{module.__name__.rsplit('.', 1)[-1]}.{attr}"

        def labelled(*a, **k):
            with torch.profiler.record_function(label):
                return inner(*a, **k)

        setattr(module, attr, labelled)
        self._undo.append((module, attr, fn))
        return True

    def restore(self) -> None:
        while self._undo:
            module, attr, fn = self._undo.pop()
            setattr(module, attr, fn)


def merged(intervals):
    """The union of (start, end) intervals as disjoint sorted intervals:
    overlapping device events count once (``chip_smoke.py``'s
    ``_busy_s``)."""
    out = []
    for t0, t1 in sorted(intervals):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def gaps(busy, start: float, end: float):
    """The parts of [start, end] that no busy interval covers."""
    out, t = [], start
    for b0, b1 in busy:
        if b0 > t:
            out.append((t, min(b0, end)))
        t = max(t, b1)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]


def host_label(host, starts, t: float) -> str:
    """What the host was doing at time ``t``: the innermost benchmark label
    and the innermost operation whose spans contain ``t``.  ``host`` is a
    list of (start, end, name) sorted by start, ``starts`` its starts."""
    op = lab = None
    for k in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        t0, t1, name = host[k]
        if t1 < t:
            continue
        if name.startswith(LABEL):
            lab = lab or name[len(LABEL):]
        else:
            op = op or name
        if lab and op:
            break
    if lab is None and op is None:
        return "(no host span)"
    return " > ".join(x for x in (lab, op) if x)


def reduce_trace(device, host, start: float, end: float) -> dict:
    """Busy seconds, window seconds and the breakdown of one stretch.

    ``device``: (start, end, name) of the device's own events (kernels,
    copies, sets); ``host``: (start, end, name) of host spans; times in
    microseconds on the profiler's clock; [start, end] the stretch."""
    dev = [(max(a, start), min(b, end), nm) for a, b, nm in device
           if b > start and a < end]
    busy = merged((a, b) for a, b, _ in dev)
    by_op: dict = {}
    for a, b, nm in dev:
        key = nm[:NAME_CHARS]
        by_op[key] = by_op.get(key, 0.0) + (b - a) / 1e6
    host = sorted(host)
    starts = [h[0] for h in host]
    by_gap: dict = {}
    for a, b in gaps(busy, start, end):
        key = host_label(host, starts, (a + b) / 2)
        by_gap[key] = by_gap.get(key, 0.0) + (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:TOP]

    return {"busy_s": sum(b - a for a, b in busy) / 1e6,
            "window_s": (end - start) / 1e6,
            "breakdown": {"device_ops": top(by_op), "idle_gaps": top(by_gap)}}


class Stretch:
    """torch.profiler over a few calls of the window (CPU and, on a card,
    CUDA activity).  ``stop`` ends the profile; ``reduce``, called once the
    window has closed, reads it: the reduction of the trace between the
    first and the last call label, or None where the device ran nothing.
    The benchmark's own labels, which the profiler also copies onto the
    device's timeline, are left out of the device's events."""

    CALL = LABEL + "call"

    def __init__(self, cuda: bool):
        self._prof = _profiler(cuda)
        self._prof.start()

    @staticmethod
    def call_label():
        import torch
        return torch.profiler.record_function(Stretch.CALL)

    def stop(self) -> None:
        self._prof.stop()

    def reduce(self):
        from torch.autograd import DeviceType
        device, host, calls = [], [], []
        for e in self._prof.events():
            span = (e.time_range.start, e.time_range.end, e.name)
            if e.device_type == DeviceType.CUDA:
                if not e.name.startswith(("aten::", LABEL)):
                    device.append(span)
            elif e.name == self.CALL:
                calls.append(span)
            else:
                host.append(span)
        if not (calls and device):
            return None
        return reduce_trace(device, host + calls, min(c[0] for c in calls),
                            max(c[1] for c in calls))


def _profiler(cuda: bool):
    import warnings

    from torch.profiler import ProfilerActivity, profile
    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def warm_profiler(cuda: bool, fn) -> None:
    """One short profile around ``fn()``, so that the profiler's own
    start-up (CUPTI) is paid in set-up and not inside the window."""
    prof = _profiler(cuda)
    prof.start()
    fn()
    prof.stop()
