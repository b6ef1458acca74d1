"""bfsp_host_syncs (layer "algorithms"): points per BFS parent tree where
the host waits for the card, by the program's own counter
``host_syncs``: each level's ``frontier.nvals``."""

from __future__ import annotations

from gbbench import bfs


def install(run):
    return bfs.install_counter(run, "host_syncs")
