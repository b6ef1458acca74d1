"""The edge list of a configuration, made on the device from the seed.

Both the set-up (which hands it to the program's ``Matrix.from_coo``) and
the reference (which works out its own adjacency from it) call
``generate``: the same seed gives the same edges."""

from __future__ import annotations

import dataclasses

import torch

from . import catalog

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass
class Edges:
    """Generated edges (self loops dropped where the configuration says
    so), one direction each; ``w`` in the configuration's value type."""
    src: torch.Tensor      # int32
    dst: torch.Tensor      # int32
    w: torch.Tensor
    n: int
    generated: int         # edges the generator drew


def value_dtype(cfg: dict) -> torch.dtype:
    return _DTYPES[cfg["value_dtype"]]


def generate(cfg: dict, seed: int, device, scale: int | None = None) -> Edges:
    """The configuration's edges; ``scale`` overrides its scale (tests)."""
    scale = cfg["scale"] if scale is None else scale
    gen = torch.Generator(device=device)
    gen.manual_seed(catalog.derive(seed, "edges"))
    src, dst = catalog.module("graphs", cfg["generator"]).edges(
        cfg, scale, gen, device)
    m = int(src.numel())
    gen.manual_seed(catalog.derive(seed, "weights"))
    w = catalog.module("weights", cfg["weights"]).draw(
        m, gen, device, value_dtype(cfg))
    if cfg["self_loops"] == "dropped":
        keep = src != dst
        src, dst, w = src[keep], dst[keep], w[keep]
    return Edges(src, dst, w, 1 << scale, m)


def stored(e: Edges, cfg: dict):
    """(rows, cols, values) of every stored direction: both for a
    symmetric configuration, duplicates left for the build to merge."""
    if not cfg["symmetric"]:
        return e.src, e.dst, e.w
    return (torch.cat([e.src, e.dst]), torch.cat([e.dst, e.src]),
            torch.cat([e.w, e.w]))


def has_edges(e: Edges, cfg: dict) -> torch.Tensor:
    """Bool per vertex: some stored entry starts there."""
    deg = torch.bincount(e.src.long(), minlength=e.n)
    if cfg["symmetric"]:
        deg += torch.bincount(e.dst.long(), minlength=e.n)
    return deg > 0
