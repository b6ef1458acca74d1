"""Uniform random (Erdos-Renyi) edges, GAP's urand, in torch on the device:
``edge_factor * 2**scale`` edges, each end drawn uniformly from the
``2**scale`` vertices (GAP Benchmark Suite, ``-u``; bench.py's
``uniform_graph`` on the host).  Duplicates and self loops are kept here;
the configuration says what the harness does with them.
"""

from __future__ import annotations

import torch


def edges(cfg: dict, scale: int, gen: torch.Generator, device):
    """(src, dst) int32 of ``edge_factor * 2**scale`` edges on ``device``."""
    n = 1 << scale
    m = cfg["edge_factor"] * n
    src = torch.randint(n, (m,), generator=gen, device=device,
                        dtype=torch.int32)
    dst = torch.randint(n, (m,), generator=gen, device=device,
                        dtype=torch.int32)
    return src, dst
