"""tc_host_syncs (layer "algorithms"): points per triangle count where
the host waits for the card, by the program's own counter
``host_syncs``: the flop count's total, the host copies of the row
pointers, the fallback rows' uploads and block cut, and the count read
back."""

from __future__ import annotations

from gbbench import program_trace


def install(run):
    return program_trace.install_counter(run, "host_syncs")
