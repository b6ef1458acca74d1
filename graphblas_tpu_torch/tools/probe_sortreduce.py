#!/usr/bin/env python3
"""Where the time of the C = 32768 sort-reduce kernel goes, on one card.

    python3 graphblas_tpu_torch/tools/probe_sortreduce.py [--baseline F]

Builds csrc/sortreduce.cu as it is and in variants with groups of the
kernel's stages switched off (their results are wrong; only their times
count), plus the same kernel with 16 slots a thread (512 threads) and,
with ``--baseline``, another sortreduce.cu (e.g. an earlier commit's),
each with nvcc into its own library under build/graphblas_tpu_torch/
probe/, all nvccs started together.  Then times K5 and K6 (fp32 PLUS) of
every library on the same 140 runs of 32768 slots (4,587,520: the size of
the fast SpGEMM tier's first C = 32768 block at RMAT-18), keys uniform in
[0, 2^18) with 10% SENTINEL pads: CUDA events, median of 20, the mean of
two rounds in opposite orders.  The full variants' keys are checked
against the package's own build.  Prints the card (nvidia-smi name and
power limit), the SM clock during a sustained run, each variant's
registers and spills (ptxas), and one line of times for K5 and one for
K6.  Variants:
  full    the kernel as it is
  p16     16 slots a thread, 512 threads a block
  noA     without the shuffle stages in layout A (8 <= j < 256)
  noB     without the shuffle stages in layout B (256 <= j < 8192)
  noT     without the stages inside the thread (j < 8)
  noX     without layout B inside the block (its stages and the round
          trips through shared memory of merges 512 ... 8192)
  noP     without the exchange between blocks (j >= 8192)
  bare    with none of the above: load, scan, store, barriers
"""

import argparse
import ctypes
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):       # run as a script from a checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from graphblas_tpu_torch.core import monoid as TM  # noqa: E402
from graphblas_tpu_torch.kernels import _cuda  # noqa: E402
from graphblas_tpu_torch.kernels import sortreduce as SRD  # noqa: E402

C = 32768
RUNS = 140
SWITCHES = [   # (group, text in the kernel, guarded text)
    ("A", "shfl_stage(r, ga, k, j, j / kP);"),
    ("B", "shfl_stage(r, gb, k, j, j / kWide);"),
    ("T", "thread_stages(r, ga, k);"),
    ("P", "cluster_stage(r, ik, iv, it, gb, sb, k, j);"),
    ("P", "put_tile(cluster.map_shared_rank(ik, prank),"),
]
VARIANTS = {"full": "", "noA": "A", "noB": "B", "noT": "T", "noX": "BX",
            "noP": "P", "bare": "ABTPX"}


def variant_source(src, off, p=8):
    for group, text in SWITCHES:
        assert text in src, text
        src = src.replace(text, f"if (!NO_{group}) {text}")
    text = "    if (k > kWide) {"
    assert text in src, text
    src = src.replace(text, "    if (!NO_X && k > kWide) {")
    if p != 8:
        text = "constexpr int kP = 8;"
        assert text in src, text
        src = src.replace(text, f"constexpr int kP = {p};")
    return "".join(f"#define NO_{g} {int(g in off)}\n"
                   for g in "ABTPX") + src


def build(sources):
    """{name: source text} -> {name: loaded library}, one nvcc each, all
    started together; prints ptxas's registers and spills of the fp32
    PLUS instances of the C = 32768 kernel."""
    out_dir = _cuda.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _cuda._nvcc()
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_cuda.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log[-4000:]}")
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if "Compiling entry function" in ln and "IfLi0E" in ln and \
                    "cluster" in ln:
                print(f"{name}: " + " / ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4]))
        so = ctypes.CDLL(str(out_dir / f"{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int64
        so.gb_sort_reduce.argtypes = [I, I, P, P, P, P, P, P, P, I, I, I, P]
        so.gb_sort_reduce.restype = ctypes.c_int
        libs[name] = so
    return libs


def time_ms(fn, reps=20, warm=3):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in evs]))


def smi(query):
    return subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another sortreduce.cu to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_sortreduce: no CUDA device", file=sys.stderr)
        return 2
    src = _cuda.SOURCES["sortreduce"].read_text()
    sources = {n: variant_source(src, off) for n, off in VARIANTS.items()}
    sources["p16"] = variant_source(src, "", p=16)
    if args.baseline:
        sources["baseline"] = Path(args.baseline).read_text()
    t0 = time.perf_counter()
    libs = build(sources)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)

    rng = np.random.default_rng(5)
    kn = rng.integers(0, 1 << 18, (RUNS, C))
    kn[rng.random((RUNS, C)) < 0.1] = SRD.SENTINEL
    keys = torch.from_numpy(kn.reshape(-1).astype(np.int32)).cuda()
    vals = torch.from_numpy(rng.standard_normal(RUNS * C)
                            .astype(np.float32)).cuda()
    toks = torch.where(keys == SRD.SENTINEL, 0, 2).int()
    toks[::7] = torch.where(keys[::7] == SRD.SENTINEL, 0, 1).int()
    ok, ov = torch.empty_like(keys), torch.empty_like(vals)

    def call(so, tk):
        err = so.gb_sort_reduce(
            1, 0, keys.data_ptr(), None, vals.data_ptr(),
            None if tk is None else tk.data_ptr(), ok.data_ptr(), None,
            ov.data_ptr(), RUNS, C, 1, torch.cuda.current_stream().cuda_stream)
        assert err == 0, err

    for tk in (None, toks):
        want = SRD.sort_reduce_rows(keys, vals, C, TM.PLUS) if tk is None \
            else SRD.sort_reduce_rows_tok(keys, vals, tk, C, TM.PLUS)
        for name in ("full", "p16", "baseline"):
            if name in libs:
                call(libs[name], tk)
                torch.cuda.synchronize()
                assert torch.equal(ok, want[0]), (name, tk is not None)
    clocks, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            clocks.append(smi("clocks.sm"))
            time.sleep(0.25)

    th = threading.Thread(target=sample)
    th.start()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 3:
        for _ in range(50):
            call(libs["full"], None)
        torch.cuda.synchronize()
    stop.set()
    th.join()
    print(f"{smi('name,power.limit')} | SM clock during a sustained run: "
          + ", ".join(clocks[2:6]), flush=True)
    for tag, tk in (("K5", None), ("K6", toks)):
        res = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                res.setdefault(name, []).append(
                    time_ms(lambda: call(libs[name], tk)))
        print(f"{tag}@{C} ms on {RUNS * C} slots: " + " | ".join(
            f"{n} {np.mean(v):.4f}" for n, v in res.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
