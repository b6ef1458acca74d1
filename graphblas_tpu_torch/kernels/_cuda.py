"""Build, load and call the CUDA kernels of ``csrc/*.cu``.

Each source (``SOURCES``) is compiled at first use with ``nvcc`` into its
own shared library with a plain C interface, keyed by a hash of the
source and the flags, under ``build/graphblas_tpu_torch/`` at the root of
the checkout, and loaded with ctypes.  (``torch.utils.cpp_extension``
would include PyTorch's headers and take minutes per build.)  ``build()``
starts one ``nvcc`` per missing library, all at once.  Nothing here runs
at import time: the CPU tests import this module on machines with no
compiler and no card.  A build failure raises; there is no fallback.
Threads of one process that first call a kernel together (each under
its own ``Context``) build and load each library once: ``build()`` and
``lib()`` hold one lock, and every compiler writes a temporary file of
its own.

Each call launches on ``torch.cuda.current_stream()``, checks the
launcher's ``cudaGetLastError()`` and raises if it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {"spmv": CSRC / "spmv.cu", "sortreduce": CSRC / "sortreduce.cu",
           "permute": CSRC / "permute.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "graphblas_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict = {}
_lock = threading.RLock()   # build() and lib()'s build-and-load


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build graphblas_tpu_torch/csrc/*.cu")
    return found


def library_path(name: str) -> Path:
    tag = hashlib.sha256(SOURCES[name].read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgb_{name}_{tag}.so"


def build(names=None) -> dict:
    """Compile the named sources (default all) whose library does not
    exist yet, one ``nvcc`` each, all started together; returns
    {name: library path}.  Each compiler's resource report (``-Xptxas
    -v``) is kept in ``<library>.log``."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        out = {n: library_path(n) for n in names}
        todo = [n for n in names if not out[n].exists()]
        if todo:
            _compile(todo, out)
    return out


def _compile(todo, out) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_name(f"{out[n].name}.{os.getpid()}."
                               f"{threading.get_ident()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for n, (cmd, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n"
                          f"{log}")
            continue
        out[n].with_name(out[n].name + ".log").write_text(log)
        os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build_log(name: str) -> str:
    log = library_path(name).with_name(library_path(name).name + ".log")
    return log.read_text() if log.exists() else ""


def _bind_spmv(so) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int64
    so.gb_spmv_merge_f32.argtypes = [P, P, P, P, P, P, P, I, I, I, P]
    so.gb_spmv_merge_f32.restype = ctypes.c_int
    so.gb_spmv_merge_planned.argtypes = [I, I, I, P, P, P, P, P, P, P, P,
                                         I, I, I, P]
    so.gb_spmv_merge_planned.restype = ctypes.c_int
    so.gb_spmv_partition.argtypes = [P, P, I, I, I, P]
    so.gb_spmv_partition.restype = ctypes.c_int


def _bind_sortreduce(so) -> None:
    P, I = ctypes.c_void_p, ctypes.c_int64
    so.gb_sort_reduce.argtypes = [I, I, P, P, P, P, P, P, P, I, I, I, P]
    so.gb_sort_reduce.restype = ctypes.c_int
    so.gb_sort_pair1.argtypes = [P, P, I, I, I, P]
    so.gb_sort_pair1.restype = ctypes.c_int
    so.gb_sort_reduce_info.argtypes = [I, I, P]
    so.gb_sort_reduce_info.restype = ctypes.c_int


def _bind_permute(so) -> None:
    P, I, C = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    so.gb_permute_gather.argtypes = [P, C, I, P, P, I, P, P, I, I, I, P, P]
    so.gb_permute_gather.restype = ctypes.c_int
    so.gb_permute_pair_bytes.argtypes = [I, I]
    so.gb_permute_pair_bytes.restype = I


_BIND = {"spmv": _bind_spmv, "sortreduce": _bind_sortreduce,
         "permute": _bind_permute}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one source (built on first use).  Each
    library exports its own ``gb_error_string``."""
    so = _libs.get(name)
    if so is not None:
        return so
    with _lock:
        so = _libs.get(name)
        if so is None:
            so = ctypes.CDLL(str(build([name])[name]))
            _BIND[name](so)
            so.gb_error_string.argtypes = [ctypes.c_int]
            so.gb_error_string.restype = ctypes.c_char_p
            _libs[name] = so
    return so


def _check(err: int, name: str, source: str = "spmv") -> None:
    if err != 0:
        msg = lib(source).gb_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {msg} ({err})")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, device,
            numel: int | None = None) -> None:
    """Raise unless ``t`` is a contiguous 1-D tensor of ``dtype`` on
    ``device`` (with ``numel`` elements when given)."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name}: must be a contiguous 1-D tensor")
    if numel is not None and t.numel() != numel:
        raise ValueError(f"{name}: {t.numel()} elements, expected {numel}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


SPMV_TILE = 2048     # merge-path steps per thread block: kTile in spmv.cu

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
ADD_CODES = {"plus": 0, "min": 1, "max": 2}
MUL_CODES = {"times": 0, "plus": 1, "first": 2, "second": 3, "pair": 4}


def spmv_tiles(m: int, nnz: int) -> int:
    """Merge-path tiles (thread blocks, carry entries) of an m-row CSR
    matrix with nnz nonzeros."""
    return -(-(m + nnz) // SPMV_TILE)


def _carries(y, nnz: int):
    """Scratch for the carry of each tile: its row and its partial."""
    tiles = spmv_tiles(y.numel(), nnz)
    return (torch.empty(tiles, dtype=torch.int32, device=y.device),
            torch.empty(tiles, dtype=y.dtype, device=y.device))


def spmv_merge_f32(indptr, indices, values, x, y) -> None:
    """y = A x (plus-times fp32) over CSR arrays, on one card: the
    merge-path kernel, then the carry pass."""
    carry_row, carry_val = _carries(y, indices.numel())
    with torch.cuda.device(y.device):
        err = lib("spmv").gb_spmv_merge_f32(
            indptr.data_ptr(), indices.data_ptr(), values.data_ptr(),
            x.data_ptr(), y.data_ptr(), carry_row.data_ptr(),
            carry_val.data_ptr(), y.numel(), indices.numel(), SPMV_TILE,
            _stream(y.device))
    _check(err, "spmv_merge_f32")


def spmv_merge_planned(indptr, tile_row, indices, values, x, y, add: str,
                       mul: str) -> None:
    """y = A (add.mul) x over a plan's tiles, on one card: both passes."""
    carry_row, carry_val = _carries(y, indices.numel())
    with torch.cuda.device(y.device):
        err = lib("spmv").gb_spmv_merge_planned(
            _DTYPE_CODES[values.dtype], ADD_CODES[add], MUL_CODES[mul],
            indptr.data_ptr(), tile_row.data_ptr(), indices.data_ptr(),
            values.data_ptr(), x.data_ptr(), y.data_ptr(),
            carry_row.data_ptr(), carry_val.data_ptr(), y.numel(),
            indices.numel(), SPMV_TILE, _stream(y.device))
    _check(err, f"spmv_merge_planned<{values.dtype}, {add}, {mul}>")


def spmv_partition(indptr, tile_row, nnz: int) -> None:
    """tile_row = the merge-path tiling of an (indptr.numel() - 1)-row
    CSR with nnz nonzeros (``spmv_route._tile_rows``), on one card."""
    with torch.cuda.device(indptr.device):
        err = lib("spmv").gb_spmv_partition(
            indptr.data_ptr(), tile_row.data_ptr(), indptr.numel() - 1, nnz,
            SPMV_TILE, _stream(indptr.device))
    _check(err, "spmv_partition")


# sortreduce.cu: value plane codes and monoid op codes (see the source)
SR_VDTYPE = {torch.int32: 0, torch.float32: 1}
SR_OPS = {"plus": 0, "times": 1, "min": 2, "max": 3, "lor": 4, "land": 5,
          "lxor": 6, "eq": 7}


def _ptr(t):
    return None if t is None else t.data_ptr()


def sort_reduce(keys, keys2, vals, toks, okeys, okeys2, ovals, C: int,
                op: str, want_token: bool) -> None:
    """K5/K6/K8 over ``keys.numel() // C`` runs of C slots, on one card."""
    dev = keys.device
    with torch.cuda.device(dev):
        err = lib("sortreduce").gb_sort_reduce(
            SR_VDTYPE[vals.dtype], SR_OPS[op], keys.data_ptr(), _ptr(keys2),
            vals.data_ptr(), _ptr(toks), okeys.data_ptr(), _ptr(okeys2),
            ovals.data_ptr(), keys.numel() // C, C, int(bool(want_token)),
            _stream(dev))
    _check(err, f"sort_reduce<{vals.dtype}, {op}, C={C}>", "sortreduce")


def sort_pair1(keys, out, C: int, want_token: bool) -> None:
    """K7 over ``keys.numel() // C`` runs of C slots, on one card (``out``
    16-byte aligned)."""
    dev = keys.device
    with torch.cuda.device(dev):
        err = lib("sortreduce").gb_sort_pair1(
            keys.data_ptr(), out.data_ptr(), keys.numel() // C, C,
            int(bool(want_token)), _stream(dev))
    _check(err, f"sort_pair1<C={C}>", "sortreduce")


# sortreduce.cu: what rides the sort (the Mode enum)
SR_MODES = {"K5": 0, "K6": 1, "K7": 2, "K8": 3, "K8T": 4}


def sort_reduce_info(mode: str, C: int) -> dict:
    """The sort-reduce kernel that runs ``mode`` (a key of ``SR_MODES``;
    fp32 PLUS, K7's int32 counts) at class C on the current card:
    ``resident`` the most blocks an SM holds at once (C <= 8192) or
    clusters the card holds (C = 32768), registers and local memory
    (spills) a thread, static and dynamic shared memory a block."""
    out = (ctypes.c_int32 * 5)()
    err = lib("sortreduce").gb_sort_reduce_info(
        SR_MODES[mode], int(C), ctypes.cast(out, ctypes.c_void_p))
    _check(err, "sort_reduce_info", "sortreduce")
    return dict(zip(("resident", "registers", "local_bytes", "static_smem",
                     "dynamic_smem"), out))


def permute_gather(perm, xs, outs, row_bytes, nx: int,
                   passes: int = 0) -> None:
    """K9: outs[k][p] = xs[k][perm[p]] for one or two payloads (rows of
    ``row_bytes[k]`` bytes) through one int32 or int64 ``perm``, on one
    card, in ``passes`` L2-blocked passes, 0 for as many as the bytes it
    gathers call for (``csrc/permute.cu``; two payloads that pack into one
    row get their scratch here)."""
    so = lib("permute")
    dev = perm.device
    (x0, x1), (o0, o1) = (list(xs) + [None])[:2], (list(outs) + [None])[:2]
    w1 = row_bytes[1] if len(xs) > 1 else 0
    pair = so.gb_permute_pair_bytes(row_bytes[0], w1) if w1 else 0
    pairs = torch.empty(nx * pair, dtype=torch.uint8, device=dev) \
        if pair else None
    with torch.cuda.device(dev):
        err = so.gb_permute_gather(
            perm.data_ptr(), perm.element_size(), perm.numel(),
            x0.data_ptr(), o0.data_ptr(), row_bytes[0], _ptr(x1), _ptr(o1),
            w1, nx, passes, _ptr(pairs), _stream(dev))
    _check(err, "permute_gather", "permute")
