"""Graph500 SSSP edge weights: one uniform [0, 1) float per edge."""

from __future__ import annotations

import torch


def draw(m: int, gen: torch.Generator, device, dtype) -> torch.Tensor:
    return torch.rand(m, generator=gen, device=device, dtype=dtype)
