"""Gaussian-integer demo — the reference's Demo/Program/gauss_demo.c
analog: a user-defined struct type {int real; int imag}, user add/mult
operators, a user monoid + semiring, and matrix algebra over it.
Run: python -m graphblas_tpu_torch.examples.gauss_demo"""

import numpy as np
import torch

import graphblas_tpu_torch as gt
from graphblas_tpu_torch.core import config
from graphblas_tpu_torch.core import types as T


def gauss_mult(x, y):
    xr, xi = x[..., 0], x[..., 1]
    yr, yi = y[..., 0], y[..., 1]
    return torch.stack([xr * yr - xi * yi, xr * yi + xi * yr], dim=-1)


def algebra():
    """(Gauss type, its add monoid, its plus-times semiring)."""
    # user-defined struct type (reference: GrB_Type_new(&Gauss, sizeof..))
    gauss = T.struct_type("Gauss", np.int64, (2,))
    add = gt.binary_op(lambda x, y: x + y, "gauss_add", commutative=True)
    mult = gt.binary_op(gauss_mult, "gauss_mult")
    add_mon = gt.make_monoid(add, identity=np.array([0, 0]))
    return gauss, add_mon, gt.make_semiring(add_mon, mult,
                                            "gauss_plus_times")


def main(device=None, n: int = 4) -> dict:
    gauss, add_mon, sr = algebra()
    rng = np.random.default_rng(0)
    va = np.stack([rng.integers(-3, 4, (n, n)),
                   rng.integers(-3, 4, (n, n))], axis=-1)
    dev = config.default_device(device)
    A = gt.Matrix((n, n), gauss, gt.FULL,
                  values=torch.from_numpy(va).to(dev))
    C = gt.mxm(A, A, sr)
    cv, _ = C.to_dense_pair()
    got = cv.cpu().numpy()
    ca = va[..., 0] + 1j * va[..., 1]
    want = ca @ ca
    assert (got[..., 0] == want.real).all() \
        and (got[..., 1] == want.imag).all()
    s = gt.reduce_scalar(C, add_mon)
    return {"C": got, "sum": s, "matches": True}


if __name__ == "__main__":
    from graphblas_tpu_torch.examples import cli_device
    dev = cli_device(__doc__)
    gt.init()
    r = main(dev)
    got = r["C"]
    print("C = A*A over the Gaussian-integer semiring:")
    for i in range(got.shape[0]):
        print("  " + "  ".join(f"{got[i, j, 0]:4d}{got[i, j, 1]:+4d}i"
                               for j in range(got.shape[1])))
    s = r["sum"]
    print("sum(C) =", f"{s[0]}{s[1]:+d}i")
    print("matches numpy complex reference: OK")
