"""Published peaks of one NVIDIA H100 SXM (data sheet; dense rates) and the
least time of a kernel call against them.

Frozen from ``chip_smoke.py``'s ``bound`` and ``spmv_bound``: the least
time is the larger of the compulsory bytes over the HBM rate and the
operations over the float32 rate outside the tensor cores.  The peaks
assume the card's full 700 W; ``run.py`` prints the card's power limit
beside every run.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12     # HBM3, 80 GB
FP32_OPS_S = 67e12        # float32 outside the tensor cores
INDEX_BYTES = 4           # the port's int32 indptr and indices


def least_s(nbytes: float, ops: float) -> float:
    """Seconds the card needs at least for ``nbytes`` and ``ops``."""
    return max(nbytes / HBM_BYTES_S, ops / FP32_OPS_S)


def spmv_bytes(m: int, n: int, nnz: int, vbytes: int, xbytes: int) -> int:
    """y = A x with A an m x n CSR of nnz entries: indptr, indices,
    values (``vbytes`` each; 0 where the product needs only the pattern)
    and x each read once, y written once."""
    return (INDEX_BYTES * (m + 1) + nnz * (INDEX_BYTES + vbytes)
            + xbytes * (n + m))


def spmv_ops(nnz: int) -> int:
    """One multiply and one add per stored entry."""
    return 2 * nnz
