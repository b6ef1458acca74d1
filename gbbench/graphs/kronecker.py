"""Graph500 Kronecker (R-MAT) edges, in torch on the device.

Frozen from the port's ``graphblas_tpu_torch.testing.rmat_edges`` (host
numpy; bench_real.py's generator), rewritten for the card: per bit level
one uniform draw per edge picks the quadrant with probabilities
A/B/C/D = ``initiator``, then the vertex labels are permuted at random
(Graph500 specification, section 3).  Duplicates and self loops are kept
here; the configuration says what the harness does with them.
"""

from __future__ import annotations

import torch


def edges(cfg: dict, scale: int, gen: torch.Generator, device):
    """(src, dst) int32 of ``edge_factor * 2**scale`` edges on ``device``."""
    a, b, c, _ = cfg["initiator"]
    n = 1 << scale
    m = cfg["edge_factor"] * n
    src = torch.zeros(m, dtype=torch.int32, device=device)
    dst = torch.zeros(m, dtype=torch.int32, device=device)
    for lvl in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        down = r >= a + b                          # quadrants C, D
        right = ((r >= a) & (r < a + b)) | (r >= a + b + c)   # B, D
        del r
        src.bitwise_or_(down.to(torch.int32).bitwise_left_shift_(lvl))
        dst.bitwise_or_(right.to(torch.int32).bitwise_left_shift_(lvl))
    if cfg.get("vertex_permutation", True):
        perm = torch.randperm(n, generator=gen, device=device,
                              dtype=torch.int32)
        src, dst = perm[src.long()], perm[dst.long()]
    return src, dst
