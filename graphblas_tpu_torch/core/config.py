"""Global runtime state + burble tracing (counterpart of
``graphblas_tpu.core.config``; reference: Source/GB_Global.c, GB_init.c).

``kernels_enabled`` is the counterpart of the JAX package's
``pallas_enabled``: with it off every op runs its plain torch version, on
any device.  ``burble`` replicates the reference's GBURBLE diagnostics:
every op logs the method it chose.  ``device`` is where constructors put
their tensors when the caller names no device: the card by default;
``set_option("device", "cpu")`` asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Callable

import torch


@dataclasses.dataclass
class _Global:
    initialized: bool = False
    # blocking (ops finalize pending work eagerly) vs nonblocking.
    blocking: bool = False
    burble: bool = False
    printf: Callable[[str], None] = lambda s: print(s, file=sys.stderr)
    # format auto-switch thresholds (reference: GB_Global.c:124-141).
    bitmap_switch: float = 0.10   # nvals/(nrows*ncols) above which -> bitmap
    hyper_switch: float = 1.0 / 16.0  # nvec_nonempty/nvec below which -> hyper
    # default orientation for new matrices ('row' == CSR, the reference
    # default; Source/GB_init.c).
    format_default: str = "row"
    # hand-written CUDA kernels on/off; off runs the plain torch versions.
    kernels_enabled: bool = True
    # device of new tensors when a constructor is given none
    device: str = "cuda"


GLOBAL = _Global()


def default_device(device=None) -> torch.device:
    """``device``, or the ``device`` option when it is None.  A CUDA
    device raises where torch sees no card: nothing lands on the CPU
    unless the caller asks for it."""
    dev = torch.device(GLOBAL.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "graphblas_tpu_torch: no CUDA card; pass device='cpu' or "
            "set_option('device', 'cpu') to run on the CPU")
    return dev


def init(mode: str = "nonblocking") -> None:
    """GrB_init (reference: Source/GB_init.c:60-197)."""
    GLOBAL.initialized = True
    GLOBAL.blocking = (mode == "blocking")
    if os.environ.get("GB_BURBLE"):
        GLOBAL.burble = True


def finalize() -> None:
    """GrB_finalize."""
    GLOBAL.initialized = False


def set_option(name: str, value) -> None:
    """GrB_set(GrB_GLOBAL, ...) analog."""
    if not hasattr(GLOBAL, name):
        raise KeyError(f"unknown global option {name!r}")
    setattr(GLOBAL, name, value)


def get_option(name: str):
    """GrB_get(GrB_GLOBAL, ...) analog."""
    return getattr(GLOBAL, name)


def burble(msg: str, *args) -> None:
    if GLOBAL.burble:
        GLOBAL.printf("[GB] " + (msg % args if args else msg))

