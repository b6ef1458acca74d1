"""GAP's SSSP edge weights: one uniform integer from 1 to 255 per edge,
held in the configuration's value type (float32 holds every one, and every
sum of them below 2**24, exactly)."""

from __future__ import annotations

import torch


def draw(m: int, gen: torch.Generator, device, dtype) -> torch.Tensor:
    return torch.randint(1, 256, (m,), generator=gen, device=device,
                         dtype=torch.int32).to(dtype)
