"""Build, load and call the CUDA kernels of ``csrc/spmv.cu``.

The source is compiled at first use with ``nvcc`` into a shared library
with a plain C interface, keyed by a hash of the source and the flags,
under ``build/graphblas_tpu_torch/`` at the root of the checkout, and
loaded with ctypes.  (PyTorch's own extension builder would include its
headers and take minutes per build.)  Nothing here runs at import time:
the CPU tests import this module on machines with no compiler and no
card.  A build failure raises; there is no fallback.

Each call launches on ``torch.cuda.current_stream()``, checks the
launcher's ``cudaGetLastError()`` and raises if it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "spmv.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "graphblas_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build graphblas_tpu_torch/csrc/spmv.cu")
    return found


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgb_spmv_{tag}.so"


def build() -> Path:
    """Compile the kernels unless this source's library exists; returns
    its path.  The compiler's resource report (``-Xptxas -v``) is kept in
    ``<library>.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def build_log() -> str:
    log = library_path().with_name(library_path().name + ".log")
    return log.read_text() if log.exists() else ""


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int64
        so.gb_spmv_rowwarp_f32.argtypes = [P, P, P, P, P, I, I, P]
        so.gb_spmv_rowwarp_f32.restype = ctypes.c_int
        so.gb_spmv_planned.argtypes = [I, I, I, P, P, P, I, P, P, P, P, P]
        so.gb_spmv_planned.restype = ctypes.c_int
        so.gb_error_string.argtypes = [ctypes.c_int]
        so.gb_error_string.restype = ctypes.c_char_p
        _lib = so
    return _lib


def _check(err: int, name: str) -> None:
    if err != 0:
        msg = lib().gb_error_string(err).decode()
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


def spmv_rowwarp_f32(indptr, indices, values, x, y, m: int) -> None:
    """y[:m] = A x (plus-times fp32) over CSR arrays on one card."""
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    grid = min(-(-m // 8), sms * 32)      # 8 warps a block, grid-strided
    with torch.cuda.device(y.device):
        err = lib().gb_spmv_rowwarp_f32(
            indptr.data_ptr(), indices.data_ptr(), values.data_ptr(),
            x.data_ptr(), y.data_ptr(), m, grid, _stream(y.device))
    _check(err, "spmv_rowwarp_f32")


_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
ADD_CODES = {"plus": 0, "min": 1, "max": 2}
MUL_CODES = {"times": 0, "plus": 1, "first": 2, "second": 3, "pair": 4}


def spmv_planned(sub_start, sub_end, block_ptr, indices, values, x, y_sub,
                 add: str, mul: str) -> None:
    """y_sub = A (add.mul) x over a plan's sub-rows, on one card."""
    nblocks = block_ptr.numel() - 1
    with torch.cuda.device(y_sub.device):
        err = lib().gb_spmv_planned(
            _DTYPE_CODES[values.dtype], ADD_CODES[add], MUL_CODES[mul],
            sub_start.data_ptr(), sub_end.data_ptr(), block_ptr.data_ptr(),
            nblocks, indices.data_ptr(), values.data_ptr(), x.data_ptr(),
            y_sub.data_ptr(), _stream(y_sub.device))
    _check(err, f"spmv_planned<{values.dtype}, {add}, {mul}>")
