"""User-defined types/operators/semirings demo — the reference's
gauss_demo / wildtype_demo analog (user-defined algebra without any JIT
machinery: operators are torch callables).
Run: python -m graphblas_tpu_torch.examples.semiring_demo"""

import numpy as np
import torch

import graphblas_tpu_torch as gt

# a user-defined semiring: log-sum-exp "tropical softmax"
LSE = gt.make_monoid(gt.binary_op(torch.logaddexp, "logaddexp",
                                  commutative=True), identity=-np.inf)
LSE_PLUS = gt.make_semiring(LSE, gt.operators.PLUS, "LSE_PLUS")
# a user-defined unary op, through apply
CLIP01 = gt.unary_op(lambda x: torch.clamp(x, 0.0, 1.0), "clip01")


def main(device=None) -> dict:
    # shortest-path semiring: min-plus over fp64
    A = gt.Matrix.from_coo([0, 0, 1, 2], [1, 2, 2, 3],
                           [1.0, 4.0, 1.0, 1.0], (4, 4), device=device)
    d = gt.Vector.from_dense(np.array([0.0, np.inf, np.inf, np.inf]),
                             device=A.device)
    for _ in range(3):
        step = gt.vxm(d, A, gt.semiring.MIN_PLUS)
        d = gt.ewise_add(d, step, gt.operators.MIN)
    dv, _ = d.to_dense_1d()

    B = gt.Matrix.from_dense(np.log(np.ones((3, 3)) / 3), device=A.device)
    v = gt.Vector.from_dense(np.log(np.ones(3) / 3), device=A.device)
    wv, _ = gt.mxv(B, v, LSE_PLUS).to_dense_1d()

    C = gt.apply(gt.Matrix.from_dense(np.array([[-1.0, 0.5], [2.0, 0.1]]),
                                      device=A.device), CLIP01)
    return {"distances": dv.cpu().numpy(), "lse": wv.cpu().numpy(),
            "clipped": C.to_scipy().toarray()}


if __name__ == "__main__":
    from graphblas_tpu_torch.examples import cli_device
    dev = cli_device(__doc__)
    gt.init()
    r = main(dev)
    print("min-plus distances from 0:", r["distances"])   # [0, 1, 2, 3]
    print("log-sum-exp mxv:", r["lse"])
    print("clipped:\n", r["clipped"])
