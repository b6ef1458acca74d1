"""bfsp_idle_pct (layer "device"): ``idle_pct``'s reading in the BFS
parent tree's cell, under a name of its own: the share of the traced
stretch (a few whole calls under torch.profiler) in which no operation
of the device ran."""

from __future__ import annotations

from gbbench import catalog


def install(run):
    return catalog.module("metrics", "idle_pct").install(run)
