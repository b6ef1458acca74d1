"""Context demo — the reference's Demo/Program/context_demo analog
(nested user parallelism: per-thread GxB_Context dividing resources).
Here several host threads run GraphBLAS ops concurrently, each under its
own Context, which names the device its tensors go to; the first of
them to reach a kernel builds it, once.
Run: python -m graphblas_tpu_torch.examples.context_demo"""

import threading

import numpy as np
import scipy.sparse as sps
import torch

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.core import context


def run_threads(A, x: torch.Tensor, device, threads: int = 4) -> dict:
    """y = A x (plus-times) in ``threads`` threads at once, each under
    its own Context(device=...): {thread id: y as a tensor}."""
    results, errors = {}, []
    start = threading.Barrier(threads)

    def worker(tid):
        try:
            with gt.Context(device=device, name=f"worker{tid}"):
                xv = gt.Vector.from_dense(context.device_put_ctx(x))
                start.wait()
                y = gt.mxv(A, xv, gt.semiring.PLUS_TIMES)
                results[tid] = y.to_dense_1d()[0]
        except Exception as exc:    # noqa: BLE001 - raised below
            errors.append(exc)

    pool = [threading.Thread(target=worker, args=(i,))
            for i in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    if errors:
        raise errors[0]
    return results


def main(device=None, n: int = 500, density: float = 0.01,
         threads: int = 4) -> dict:
    S = sps.random(n, n, density, format="csr", random_state=0)
    A = gt.Matrix.from_scipy(S, device=device)
    ys = run_threads(A, torch.ones(n, dtype=torch.float64), A.device,
                     threads)
    sums = {tid: float(gt.reduce_scalar(gt.Vector.from_dense(y),
                                        gt.monoid.PLUS))
            for tid, y in ys.items()}
    assert len(set(sums.values())) == 1
    return {"results": sums,
            "y": ys[0].cpu().numpy(), "want": S @ np.ones(n)}


if __name__ == "__main__":
    from graphblas_tpu_torch.examples import cli_device
    dev = cli_device(__doc__)
    gt.init()
    r = main(dev)
    print("per-thread results (all equal):", r["results"])
