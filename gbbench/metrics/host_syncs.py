"""host_syncs (layer "algorithms"): points per algorithm call where the
host waits for the card, by the program's own counter ``host_syncs``: the
fused loops' stop tests, the plan build's pointer-array fetch and its
tiling's upload."""

from __future__ import annotations

from gbbench import program_trace


def install(run):
    return program_trace.install_counter(run, "host_syncs")
