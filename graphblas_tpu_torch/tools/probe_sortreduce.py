#!/usr/bin/env python3
"""Where the time of the sort-reduce kernels goes, on one card.

    python3 graphblas_tpu_torch/tools/probe_sortreduce.py [--baseline F]

Builds csrc/sortreduce.cu as it is and in variants with groups of the
kernels' stages switched off (their results are wrong; only their times
count), plus the one-block kernel with 16 or 32 warps a block at C <=
2048 and, with ``--baseline``, another sortreduce.cu (e.g. an earlier
commit's), each with nvcc into its own library under build/
graphblas_tpu_torch/probe/, all nvccs started together (fp32 PLUS and K7
only).  Then times every library on the same inputs: K5, K6, K7 and K8
(fp32 PLUS; K7 its counts) on 8192 runs of 2048 slots (16,777,216: the
size of the SELL tier's pass-1 block at bench.py's graph), keys uniform
in [0, 2^18) with 10% SENTINEL pads (K8: the key over two planes, K7:
packed (rank, j, is_product) keys with a fifth of them mask tokens), and
K5 and K6 on 140 runs of 32768 slots (4,587,520: the fast tier's first
C = 32768 block at RMAT-18): CUDA events, median of 20, the mean of two
rounds in opposite orders.  The full variants' outputs are checked
against the package's own build.  Prints the card (nvidia-smi name and
power limit), the SM clock during a sustained run, each variant's
registers and spills (ptxas) of the timed kernels, and one line of times
for each kernel and C.
Variants:
  full    the kernels as they are
  w16     the one-block kernel with 16 warps (4096 slots, two blocks an
          SM) at C <= 2048, not 8 (2048 slots, four blocks an SM)
  w32     the same with 32 warps (8192 slots, one block an SM)
  noA     without the shuffle stages in layout A (8 <= j < 256)
  noB     without the shuffle stages in layout B (256 <= j < 8192)
  noT     without the stages inside the thread (j < 8)
  noX     without layout B inside the block (its stages and the round
          trips through shared memory of merges 512 ... 8192)
  noP     without the exchange between blocks (j >= 8192, C = 32768)
  bare    with none of the above: load, scan, store, barriers
"""

import argparse
import ctypes
import re
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

SWITCHES = [   # (group, text in the kernels, guarded text)
    ("A", "shfl_stage(r, ga, k, j, j / kP);"),
    ("B", "shfl_stage(r, gb, k, j, j / kLaneB);"),
    ("T", "thread_stages(r, ga, k);"),
    ("P", "cluster_stage(r, inbox, gb, sb, k, j);"),
    ("P", "put_tile<kCWarps, kQ>(cluster.map_shared_rank(inbox, prank),"),
]
VARIANTS = {"full": "", "noA": "A", "noB": "B", "noT": "T", "noX": "BX",
            "noP": "P", "bare": "ABTPX"}
# (kernel, C, runs): the timed calls
CALLS = [("K5", 2048, 8192), ("K6", 2048, 8192), ("K7", 2048, 8192),
         ("K8", 2048, 8192), ("K5", 32768, 140), ("K6", 32768, 140)]
_WARPS = re.compile(r"constexpr int kRunWarps = \d+;")
_LAUNCH = re.compile(r"      case OP_\w+: e = launch_sr<(int32_t|float), "
                     r"OP_(\w+)>\(pl, nruns, s\); break;\n")


def variant_source(src, off, warps=None):
    """The source with the stage groups in ``off`` switched off, the
    one-block kernel at ``warps`` warps for C <= 4096 (None: as it is),
    and only the fp32 PLUS entry of gb_sort_reduce instantiated."""
    for group, text in SWITCHES:
        assert text in src, text
        src = src.replace(text, f"if (!NO_{group}) {text}")
    text = "    if (k > kSplit) {"
    assert text in src, text
    src = src.replace(text, "    if (!NO_X && k > kSplit) {")
    if warps is not None:
        src, n = _WARPS.subn(f"constexpr int kRunWarps = {warps};", src)
        assert n == 1, "kRunWarps"
    assert _LAUNCH.search(src)
    keep = ("float", "PLUS")
    src = _LAUNCH.sub(lambda m: m[0] if m.groups() == keep else "", src)
    return "".join(f"#define NO_{g} {int(g in off)}\n"
                   for g in "ABTPX") + src


def build(sources):
    """{name: source text} -> {name: loaded library}, one nvcc each, all
    started together; prints ptxas's registers and spills of the timed
    kernels (fp32 PLUS, K7) of the full, w16 and w32 variants."""
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
    mangled = re.compile(r"(block|cluster)_regs_kernelI([fi])Li(\d)ELi(\d)E"
                         r"(?:Li(\d+)E)?")
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log[-4000:]}")
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            m = mangled.search(ln) if "Compiling entry" in ln else None
            if m and name in ("full", "w16", "w32") and m[3] == "0":
                mode = ("K5", "K6", "K7", "K8", "K8T")[int(m[4])]
                where = f"{m[1]}" + (f" {m[5]} warps" if m[5] else "")
                print(f"{name}: {mode} {where}: " + " / ".join(
                    x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4]))
        so = ctypes.CDLL(str(out_dir / f"{name}.so"))
        P, I = ctypes.c_void_p, ctypes.c_int64
        so.gb_sort_reduce.argtypes = [I, I, P, P, P, P, P, P, P, I, I, I, P]
        so.gb_sort_reduce.restype = ctypes.c_int
        so.gb_sort_pair1.argtypes = [P, P, I, I, I, P]
        so.gb_sort_pair1.restype = ctypes.c_int
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


def inputs(C, runs, rng):
    """The planes of one timed call size, on the card."""
    n = C * runs
    pad = rng.random(n) < 0.1
    kn = rng.integers(0, 1 << 18, n)
    cu = lambda a: torch.from_numpy(a.astype(np.int32)).cuda()  # noqa
    keys = cu(np.where(pad, SRD.SENTINEL, kn))
    toks = torch.where(keys == SRD.SENTINEL, 0, 2).int()
    toks[::7] = torch.where(keys[::7] == SRD.SENTINEL, 0, 1).int()
    pk = (rng.integers(0, 64, n) << 23) | (kn >> 5 << 1) | \
        (rng.random(n) < 0.8)
    return dict(
        keys=keys, toks=toks,
        vals=torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        .cuda(),
        kh=cu(np.where(pad, SRD.SENTINEL, kn >> 6)),
        kl=cu(np.where(pad, SRD.SENTINEL, (kn & 63) + (1 << 28))),
        pk=cu(np.where(pad, SRD.SENTINEL, pk)),
        ok=torch.empty_like(keys), ok2=torch.empty_like(keys),
        ov=torch.empty(n, dtype=torch.float32, device="cuda"))


def call(so, kern, C, x):
    """One launch of ``kern`` from library ``so`` on the planes ``x``."""
    runs = x["keys"].numel() // C
    stream = torch.cuda.current_stream().cuda_stream
    if kern == "K7":
        err = so.gb_sort_pair1(x["pk"].data_ptr(), x["ok"].data_ptr(), runs,
                               C, 1, stream)
    else:
        wide = kern == "K8"
        err = so.gb_sort_reduce(
            1, 0, (x["kh"] if wide else x["keys"]).data_ptr(),
            x["kl"].data_ptr() if wide else None, x["vals"].data_ptr(),
            x["toks"].data_ptr() if kern == "K6" else None,
            x["ok"].data_ptr(), x["ok2"].data_ptr() if wide else None,
            x["ov"].data_ptr(), runs, C, 1, stream)
    assert err == 0, (kern, C, err)


def reference(kern, C, x):
    """The package's own build of ``kern`` on the planes ``x``: the plane
    the check compares (K7: the counts, else the keys)."""
    if kern == "K7":
        return SRD.sort_reduce_pair1(x["pk"], C)
    if kern == "K8":
        return SRD.sort_reduce_rows_wide(x["kh"], x["kl"], x["vals"], C,
                                         TM.PLUS)[0]
    if kern == "K6":
        return SRD.sort_reduce_rows_tok(x["keys"], x["vals"], x["toks"], C,
                                        TM.PLUS)[0]
    return SRD.sort_reduce_rows(x["keys"], x["vals"], C, TM.PLUS)[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", help="another sortreduce.cu to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_sortreduce: no CUDA device", file=sys.stderr)
        return 2
    src = _cuda.SOURCES["sortreduce"].read_text()
    sources = {n: variant_source(src, off) for n, off in VARIANTS.items()}
    for w in (16, 32):
        sources[f"w{w}"] = variant_source(src, "", warps=w)
    if args.baseline:
        sources["baseline"] = Path(args.baseline).read_text()
    t0 = time.perf_counter()
    libs = build(sources)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)

    rng = np.random.default_rng(5)
    planes = {C: inputs(C, runs, rng) for _, C, runs in CALLS}
    for kern, C, _ in CALLS:
        want = reference(kern, C, planes[C])
        for name in ("full", "w16", "w32", "baseline"):
            if name in libs:
                try:
                    call(libs[name], kern, C, planes[C])
                except AssertionError as e:
                    raise AssertionError(f"{name}: {e}") from None
                torch.cuda.synchronize()
                assert torch.equal(planes[C]["ok"], want), (name, kern, C)
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
            call(libs["full"], "K5", 2048, planes[2048])
        torch.cuda.synchronize()
    stop.set()
    th.join()
    print(f"{smi('name,power.limit')} | SM clock during a sustained run: "
          + ", ".join(clocks[2:6]), flush=True)
    for kern, C, runs in CALLS:
        res = {}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                if C != 32768 or name not in ("w16", "w32"):
                    res.setdefault(name, []).append(time_ms(
                        lambda: call(libs[name], kern, C, planes[C])))
        print(f"{kern}@{C} ms on {runs * C} slots: " + " | ".join(
            f"{n} {np.mean(v):.4f}" for n, v in res.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
