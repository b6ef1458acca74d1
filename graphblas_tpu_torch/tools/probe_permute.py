#!/usr/bin/env python3
"""Where the time of K9 (the gather-permute kernel) goes, on one card.

    python3 graphblas_tpu_torch/tools/probe_permute.py [--baseline F.cu]

Builds csrc/permute.cu (and, with ``--baseline``, another permute.cu,
e.g. an earlier commit's, whose one entry ``gb_permute_gather_32`` takes
32-bit elements and an int32 perm) and times its launch shapes on the
CSR -> CSC permutation of bench.py's graph (n = 2^20, 16 uniform random
out-edges a vertex, seed 0: 16,777,086 nonzeros), the order that the
reorient's stable ``torch.sort`` of the column indices gives (int64, and
as int32):

  * one payload, fp32 and fp64, int32 and int64 perm: the passes the
    launcher picks; one pass; 2, 3, 4 or 6 L2-blocked passes (each stores
    the outputs whose source lies in its range of x; x read evict_last,
    perm evict_first);
  * two payloads, the reorient's (int32 row ids with fp32 or fp64 values,
    the int64 order): packed into one row of 8 or 16 bytes, in one pass
    and in 2 or 3 passes, and apart (one call a payload);
  * the device time of each kernel a call launches (torch.profiler) for
    fp32 in 3 passes and for the packed two payloads;
  * beside them: the baseline, ``torch.take`` (int64 perm), ``x[perm]``
    (int32), the reorient's former two library gathers (``vecid[order]``
    and ``types.take(vals, order)``) and its stable sort.

CUDA events, median of 20 after 3 warm-up calls, the mean of two rounds
in opposite orders; every variant is checked bitwise against the plain
version.  Prints the card (nvidia-smi name and
power limit) and one line a variant: ms, GB/s of compulsory bytes and
the byte bound at 3.35 TB/s.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

if __package__ in (None, ""):       # run as a script from a checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
from graphblas_tpu_torch.core import types as T  # noqa: E402
from graphblas_tpu_torch.kernels import _cuda  # noqa: E402
from graphblas_tpu_torch.kernels import segment as K  # noqa: E402

HBM_BYTES_S = 3.35e12


def graph_a():
    """bench.py's uniform graph as (indptr, indices) of its CSR."""
    import scipy.sparse as sps
    n, deg = 1 << 20, 16
    rng = np.random.default_rng(0)
    rows = rng.integers(0, n, n * deg).astype(np.int32)
    cols = rng.integers(0, n, n * deg).astype(np.int32)
    S = sps.csr_matrix((np.ones(n * deg, np.float32), (rows, cols)),
                       shape=(n, n))
    S.sum_duplicates()
    return S.indptr.astype(np.int32), S.indices.astype(np.int32)


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


def build_baseline(path):
    out_dir = _cuda.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    so_path = out_dir / "permute_baseline.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so_path),
                    str(path)], check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(so_path))
    P, I = ctypes.c_void_p, ctypes.c_int64
    so.gb_permute_gather_32.argtypes = [P, P, P, I, P]
    so.gb_permute_gather_32.restype = ctypes.c_int
    return so


def by_kernel(label, fn, calls=10):
    """Device time a call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0 and not e.key.startswith("aten::"):
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            us[name] = us.get(name, 0.0) + t / calls
    print(f"[probe permute] {label}, device us a call: " + ", ".join(
        f"{k} {v:.1f}" for k, v in sorted(us.items(), key=lambda kv: -kv[1])),
        flush=True)


def kernel(perm, xs, passes, apart=False):
    """One call of the package's K9 entry in ``passes`` passes (0: the
    launcher's choice), or with ``apart`` one call a payload."""
    outs = [torch.empty_like(x) for x in xs]
    rb = [x.element_size() * x[0].numel() for x in xs]
    nx = xs[0].shape[0]
    if apart:
        return lambda: [_cuda.permute_gather(perm, [x], [o], [w], nx, passes)
                        for x, o, w in zip(xs, outs, rb)], outs
    return lambda: _cuda.permute_gather(perm, xs, outs, rb, nx,
                                        passes), outs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="another permute.cu to time beside")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"[probe permute] {card}", flush=True)
    _cuda.lib("permute")
    ip_np, ix_np = graph_a()
    dev = torch.device("cuda")
    ip = torch.from_numpy(ip_np).to(dev)
    ix = torch.from_numpy(ix_np).to(dev)
    n = ix.numel()
    order = torch.sort(ix, stable=True)[1]
    perms = {"i64": order, "i32": order.int()}
    vecid = K.expand_rowids(ip, n, ip.numel() - 1)
    gen = torch.Generator(device=dev).manual_seed(16)
    x32 = torch.randn(n, generator=gen, device=dev)
    vals = {"fp32": x32, "fp64": torch.randn(n, generator=gen, device=dev,
                                             dtype=torch.float64)}
    rows = []

    def record(label, fn, nbytes):
        rows.append((label, fn, nbytes, [time_ms(fn)]))

    def checked(label, fn, outs, want, nbytes):
        fn()
        torch.cuda.synchronize()
        assert all(torch.equal(o, w) for o, w in zip(outs, want)), label
        record(label, fn, nbytes)

    t_sort = time_ms(lambda: torch.sort(ix, stable=True))
    for vn, x in vals.items():
        for pn, perm in perms.items():
            want = [x[perm.long()]]
            nb = n * (perm.element_size() + 2 * x.element_size())
            for passes in (0, 1, 2, 3, 4, 6):
                checked(f"1 payload {vn} perm {pn} passes={passes or 'auto'}",
                        *kernel(perm, [x], passes), want, nb)
            if pn == "i64":
                record(f"torch.take {vn} (int64 perm)",
                       lambda x=x, p=perm: torch.take(x, p), nb)
            else:
                record(f"x[perm] {vn} (int32 perm)",
                       lambda x=x, p=perm: x[p], nb)
        want = [vecid[order], x[order]]
        nb = n * (8 + 2 * (4 + x.element_size()))
        two = [vecid, x]
        for passes in (0, 1, 2, 3):
            checked(f"2 payloads int32 + {vn} perm i64 packed passes="
                    f"{passes or 'auto'}", *kernel(order, two, passes),
                    want, nb)
        checked(f"2 payloads int32 + {vn} perm i64 apart (two calls)",
                *kernel(order, two, 0, apart=True), want, nb)
        record(f"library: vecid[order] + types.take({vn}, order)",
               lambda x=x: (vecid[order], T.take(x, order)), nb)
    by_kernel("1 payload fp32 perm i32 passes=3",
              kernel(perms["i32"], [x32], 3)[0])
    for vn, x in vals.items():
        by_kernel(f"2 payloads int32 + {vn} perm i64 packed one pass",
                  kernel(order, [vecid, x], 1)[0])
    if args.baseline:
        so = build_baseline(args.baseline)
        out = torch.empty_like(x32)
        p32 = perms["i32"]

        def base():
            err = so.gb_permute_gather_32(
                x32.data_ptr(), p32.data_ptr(), out.data_ptr(), n,
                torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
        base()
        torch.cuda.synchronize()
        assert torch.equal(out, x32[p32.long()]), "baseline"
        record("baseline permute_gather_32 fp32 perm i32", base, n * 12)
    # second round in the opposite order
    for label, fn, nb, t in reversed(rows):
        t.append(time_ms(fn))
    print(f"[probe permute] n={n} stable torch.sort of the int32 indices "
          f"{t_sort:.3f} ms", flush=True)
    for label, _, nb, t in rows:
        ms = sum(t) / len(t)
        print(f"[probe permute] {label}: {ms:.4f} ms "
              f"({' / '.join(f'{v:.4f}' for v in t)}), "
              f"{nb / ms / 1e6:.1f} GB/s of {nb / 1e6:.1f} MB, bound "
              f"{nb / HBM_BYTES_S * 1e3:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
