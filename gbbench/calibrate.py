#!/usr/bin/env python3
"""Readings that the limits of a cell's comparison are set from.

    python3 gbbench/calibrate.py --workload kron.sssp --seconds 5 \\
        --seeds 11 12 13 --control bfloat16

For each seed, in one process: the cell's set-up and a window of
``--seconds`` as ``run.py`` makes them, then the comparison of the sampled
answers with the float64 reference (the lower readings), and with
``--control`` the reference computed in that lower precision put in the
program's place and held to the same comparison and limits (the upper
readings, and the control's own ``correct``, which has to be false).  One
JSON line per seed.  The benchmark's own runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def release_plan_caches() -> None:
    """Drop the CSC copies that the program's algorithm plan caches pin
    (up to five per cache, 4.3 GB each at scale 24), so that the next
    seed's build finds the card as a fresh process would."""
    from graphblas_tpu_torch.algorithms import graph as G
    for name in ("_pattern_plans", "_sssp_plans"):
        cache = getattr(G, name, None)
        if isinstance(cache, dict):
            cache.clear()


def main(argv=None) -> int:
    from gbbench import catalog, run
    run.cache_dirs()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch
    cell = catalog.cell(args.workload)
    dtypes = [getattr(torch, d) for d in args.control]
    t_start = T_START
    for seed in args.seeds:
        t = time.perf_counter()
        res = run.run_cell(cell, seed, args.seconds, False, "cuda", t_start,
                           control=dtypes,
                           log=lambda s: print(s, file=sys.stderr))
        res.pop("metrics")
        res["memory_peak_bytes"] = res.pop("_peak")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t, **res},
                         default=str), flush=True)
        release_plan_caches()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
