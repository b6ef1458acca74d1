#!/usr/bin/env python3
"""Which torch operations run on uint16, uint32 and uint64 tensors.

    python3 graphblas_tpu_torch/tools/probe_unsigned.py [--device cuda]

Calls each operation the port's op layer could apply to a value tensor
(arithmetic, comparisons, shifts, reductions, scatters, indexed writes,
sorts, casts) on a small tensor of each unsigned dtype, on the CPU and,
with ``--device cuda``, on the card too, and prints one line a dtype and
device naming the operations that raise.  The port computes on these
types through signed carriers (``core/types.py``), so it needs none of
the failing ones; the list says which of them torch could take over.
"""

import argparse

import torch

UNSIGNED = (torch.uint16, torch.uint32, torch.uint64)


def cases(x, dev):
    i = torch.tensor([0, 0, 1], device=dev)
    z = torch.zeros(3, dtype=x.dtype, device=dev)
    return {
        "add": lambda: x + x, "sub": lambda: x - x, "mul": lambda: x * x,
        "neg": lambda: -x, "floordiv": lambda: x // x,
        "div_trunc": lambda: torch.div(x, x, rounding_mode="trunc"),
        "lt": lambda: x < x, "eq": lambda: x == x, "minimum":
        lambda: torch.minimum(x, x), "and": lambda: x & x,
        "xor": lambda: x ^ x, "not": lambda: ~x, "shr": lambda: x >> 1,
        "where": lambda: torch.where(x == 1, x, x), "gather": lambda: x[i],
        "index_put": lambda: z.clone().index_put_((i,), x),
        "setitem_mask": lambda: z.clone().__setitem__(x == 1, 7),
        "cat": lambda: torch.cat([x, x]), "sort": lambda: torch.sort(x),
        "argsort": lambda: torch.argsort(x), "unique": lambda: torch.unique(x),
        "searchsorted": lambda: torch.searchsorted(x, x),
        "sum": lambda: x.sum(), "prod": lambda: x.prod(),
        "amin": lambda: x.amin(), "index_add": lambda: z.clone().index_add_(
            0, i, x), "scatter_amin": lambda: z.clone().scatter_reduce_(
            0, i, x, "amin"), "scatter_sum": lambda: z.clone().scatter_reduce_(
            0, i, x, "sum"), "to_f64": lambda: x.to(torch.float64),
        "from_f64": lambda: torch.tensor([1.5], device=dev).to(x.dtype),
        "to_i64": lambda: x.to(torch.int64), "view_signed": lambda: x.view(
            {torch.uint16: torch.int16, torch.uint32: torch.int32,
             torch.uint64: torch.int64}[x.dtype]),
        "repeat_interleave": lambda: torch.repeat_interleave(
            x, torch.tensor([1, 2, 0], device=dev)),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()
    devs = ["cpu"] + (["cuda"] if args.device == "cuda" else [])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    for dev in devs:
        for dt in UNSIGNED:
            x = torch.tensor([1, 2, 3], device=dev).to(dt)
            bad = []
            for name, f in cases(x, dev).items():
                try:
                    f()
                    if dev == "cuda":
                        torch.cuda.synchronize()
                except (RuntimeError, NotImplementedError, TypeError):
                    bad.append(name)
            print(f"{dev} {str(dt).replace('torch.', '')}: "
                  f"{len(bad)} of {len(cases(x, dev))} raise: "
                  + " ".join(bad))


if __name__ == "__main__":
    main()
