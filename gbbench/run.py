#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card(s) of this machine.

    python3 gbbench/run.py --workload kron.sssp --seed 7 --seconds 51 --trace 0

Set-up (timed from the first line of this file to the first timed call):
import the program, make the configuration's edges on the card from the
seed, build the program's ``Matrix.from_coo`` by row, and make one warm
call.  Then a closed loop of calls of the mix's entry for ``--seconds``
(one caller; the next call once the last has returned and the card has
synchronised), then the comparison with the plain reference.

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` installs
the per-layer metrics' spans and counters (``metrics/<name>.py``), runs
torch.profiler over a few calls, and prints the per-layer metrics.  The
last line of standard output is one JSON object; the last lines of
standard error are the numbers compared, each beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
from contextlib import nullcontext  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FOREIGN = ("jax", "jaxlib", "flax", "graphblas_tpu")
PROFILE_CALLS = 3      # calls of the window under torch.profiler (trace 1)


def cache_dirs(root: Path = ROOT) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = root / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: graphblas_tpu_torch is not graphblas_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FOREIGN)


class Run:
    """What a per-layer metric's ``install`` gets: ``patch`` to wrap a
    program attribute, ``sync``, ``cuda``, the cell's ``config`` and
    ``traffic``, the matrix's ``shape`` and stored entries ``nnz``, and
    after the window ``calls`` (algorithm calls in it) and ``trace`` (the
    profiled stretch)."""

    def __init__(self, cuda: bool, config: dict, traffic: dict,
                 shape: tuple, nnz: int):
        from gbbench import trace
        self.cuda = cuda
        self.config, self.traffic = config, traffic
        self.shape, self.nnz = shape, nnz
        self.patches = trace.Patches()
        self.calls = 0
        self.trace = None

    def patch(self, module, attr, make) -> bool:
        return self.patches.wrap(module, attr, make)

    def sync(self) -> None:
        if self.cuda:
            import torch
            torch.cuda.synchronize()


def card_info() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
             "power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        return f"not measured ({exc.__class__.__name__})"
    return out.stdout.strip().splitlines()[0]


def window(mix, A, seconds: float, run, sync, sample: int):
    """The closed loop: calls until ``seconds`` have passed since the
    first began, each ended by a synchronise.  Returns (per-call seconds,
    window seconds to the end of the last call, kept (i, key, answer))."""
    from gbbench import trace
    from gbbench.mix import Reservoir
    kept = Reservoir(sample, mix.sampler)
    times = []
    stretch = traced = None
    t0 = time.perf_counter()
    end = t0 + seconds
    t1 = t0
    i = 0
    while t1 < end:
        if run is not None and i == 1:
            stretch = trace.Stretch(run.cuda)
        label = trace.Stretch.call_label() if stretch else nullcontext()
        ts = time.perf_counter()
        with label:
            out = mix.call(A, i)
            sync()
        t1 = time.perf_counter()
        times.append(t1 - ts)
        kept.offer((i, mix.key(i), out))
        i += 1
        if stretch is not None and i == 1 + PROFILE_CALLS:
            stretch.stop()
            traced, stretch = stretch, None
    win_s = t1 - t0
    if stretch is not None:
        stretch.stop()
        traced = stretch
    if run is not None and traced is not None:
        run.trace = traced.reduce()
    return times, win_s, kept.kept


def judge(cell, seed: int, device, kept, scale=None, dtypes=None):
    """Numbers of the comparison: each the worst over the sampled calls of
    what ``reference/<name>.py``'s ``compare`` reads between the answer and
    the reference worked out anew from the seed's edges in float64.  With
    ``dtypes`` (the control), also the reference computed in each of those
    dtypes in the program's place: {dtype: numbers}."""
    import torch

    from gbbench import catalog, graph
    ref = catalog.module("reference", cell.traffic["reference"])
    params = cell.traffic.get("kwargs", {})
    edges = graph.generate(cell.config, seed, device, scale)
    worst = {}
    controls = {}
    for dtype in [torch.float64] + list(dtypes or ()):
        state = ref.prepare(edges, cell.config, params, dtype)
        if dtype is torch.float64:
            wants = {}
            for _, key, _ in kept:
                if key not in wants:
                    wants[key] = ref.solve(state, key, params, dtype)
            for _, key, got in kept:
                for k, v in ref.compare(got, wants[key], key).items():
                    worst[k] = max(worst.get(k, -math.inf), v)
        else:
            got = {}
            for key in wants:
                got[key] = ref.solve(state, key, params, dtype)
            nums = {}
            for key in wants:
                for k, v in ref.compare(got[key], wants[key], key).items():
                    nums[k] = max(nums.get(k, -math.inf), v)
            controls[str(dtype).replace("torch.", "")] = nums
        del state
    return worst, controls


def checks_of(numbers: dict, limits: dict) -> tuple:
    """({name: {value, limit}}, correct): every limit has its number and
    each number is at most its limit (NaN never is)."""
    out = {}
    ok = set(numbers) == set(limits)
    for name in sorted(limits):
        v = numbers.get(name, math.nan)
        out[name] = {"value": v, "limit": limits[name]}
        ok = ok and v <= limits[name]
    return out, bool(ok)


def _json_number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, scale=None, log=print, control=()):
    """Set-up, window and comparison of one run; returns the result
    object (without ``device``, which the caller adds).  ``control``:
    dtypes in which the reference is also computed in the program's place
    (``calibrate.py``); under ``controls`` each comes back held to the
    cell's limits as the program is: ``{dtype: {checks, correct}}``."""
    import torch

    from gbbench import catalog, graph, mix as MIX
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    info = {}
    t = time.perf_counter()
    import graphblas_tpu_torch as gt     # the system under test
    info["import_s"] = time.perf_counter() - t_start
    t = time.perf_counter()
    cfg = cell.config
    edges = graph.generate(cfg, seed, dev, scale)
    mix = MIX.Mix(cell.traffic, cfg, edges, seed)
    n, generated = edges.n, edges.generated
    rows, cols, vals = graph.stored(edges, cfg)
    del edges
    sync()
    info["generate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    A = gt.Matrix.from_coo(rows, cols, vals, (n, n), dup=cfg["duplicates"],
                           orient=gt.ROW)
    del rows, cols, vals
    sync()
    info["build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    mix.call(A, -1)
    sync()
    info["warm_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    stored, shape = A.nvals, (A.nrows, A.ncols)
    log(f"setup: import {info['import_s']:.3f} s, generate "
        f"{info['generate_s']:.3f} s, build {info['build_s']:.3f} s, warm "
        f"call {info['warm_s']:.3f} s; setup_s {setup_s:.3f}")
    log(f"graph: {cfg['name']} scale {scale or cfg['scale']}: {n} vertices, "
        f"{generated} generated edges, {stored} stored entries")

    run = readers = None
    if trace:
        from gbbench import trace as TR
        TR.warm_profiler(cuda, sync)
        run = Run(cuda, cfg, cell.traffic, shape, stored)
        readers = {}
        for m in cell.per_layer:
            read = catalog.module("metrics", m["name"]).install(run)
            if read is not None:
                readers[m["name"]] = read
    try:
        times, win_s, kept = window(mix, A, seconds, run, sync,
                                    int(cell.traffic["sample"]))
    finally:
        if run is not None:
            run.patches.restore()
    calls = len(times)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    metrics = {}
    if trace:
        run.calls = calls
        for m in cell.per_layer:
            v = readers[m["name"]]() if m["name"] in readers else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"setup_s": setup_s, "trial_ms": 1e3 * win_s / calls,
               "trial_p90_ms": 1e3 * (statistics.quantiles(
                   times, n=10, method="inclusive")[-1]
                   if calls > 1 else times[0])}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    log(f"window: {calls} calls in {win_s:.3f} s; call ms first "
        f"{1e3 * times[0]:.3f}, median {1e3 * statistics.median(times):.3f}, "
        f"max {1e3 * max(times):.3f}")
    log(f"memory: peak {peak} bytes allocated ({setup_peak} by the end of "
        f"set-up)" if cuda else "memory: not measured (no card)")
    del A
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers, controls = judge(cell, seed, dev, kept, scale, control)
    log(f"reference: {len(kept)} sampled calls judged in "
        f"{time.perf_counter() - t:.3f} s")
    limits = cell.traffic["limits"]
    checks, correct = checks_of(numbers, limits)
    result = {"correct": correct, "attempted": calls, "failed": 0,
              "metrics": metrics}
    if trace and run.trace is not None:
        result["trace"] = run.trace
    if control:
        result["controls"] = {
            d: dict(zip(("checks", "correct"), checks_of(nums, limits)))
            for d, nums in controls.items()}
    result["checks"] = checks
    result["_peak"] = peak
    return result


def main(argv=None) -> int:
    cache_dirs()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from gbbench import catalog
    cell = catalog.cell(args.workload)
    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gbbench: {args.workload} needs {chips} CUDA card(s); torch "
              f"sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   T_START)
    print(f"card: {card_info()}")
    found = foreign_modules()
    if found:
        print(f"gbbench: the run loaded JAX modules: {', '.join(found)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res.pop("_peak")}
    tr = res.pop("trace", None)
    if args.trace:
        if tr is None:
            print("gbbench: the profiler saw no device operation",
                  file=sys.stderr)
            return 4
        device["busy_s"], device["window_s"] = tr["busy_s"], tr["window_s"]
    checks = res.pop("checks")
    out = {**res, "device": device}
    if tr is not None:
        out["breakdown"] = tr["breakdown"]
    out["checks"] = {k: {"value": _json_number(c["value"]),
                         "limit": c["limit"]} for k, c in checks.items()}
    sys.stdout.flush()
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {str(out['correct']).lower()}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
