"""BFS demo — the reference's Demo/Program/bfs analog, using both the GrB
op tier (masked lor-land vxm, the MIN_FIRSTJ parent tree) and the fused
tier.  Run: python -m graphblas_tpu_torch.examples.bfs_demo"""

import numpy as np
import scipy.sparse as sps

import graphblas_tpu_torch as gt
from graphblas_tpu_torch import algorithms as alg


def graph(n: int = 1000, density: float = 0.005):
    """The demo's symmetric random graph (scipy CSR, fp32 ones)."""
    S = sps.random(n, n, density, format="csr", random_state=0)
    return ((S + S.T) != 0).astype(np.float32)


def main(device=None, n: int = 1000, density: float = 0.005) -> dict:
    S = graph(n, density)
    A = gt.Matrix.from_scipy(S, device=device)
    levels = alg.bfs_levels(A, source=0)
    lv, lp = levels.to_dense_1d()
    lv, lp = lv.cpu().numpy(), lp.cpu().numpy()
    fused = alg.bfs_levels_fused(A, 0).cpu().numpy()
    parents = alg.bfs_parents(A, 0)
    pv, pp = parents.to_dense_1d()
    return {"graph": repr(A), "nvals": A.nvals,
            "reached": int(lp.sum()), "max_level": int(lv[lp].max()),
            "levels": np.where(lp, lv, -1), "fused_levels": fused,
            "fused_agrees": bool((fused >= 0).sum() == int(lp.sum())),
            "parent_entries": parents.nvals,
            "parents": np.where(pp.cpu().numpy(), pv.cpu().numpy(), -1)}


if __name__ == "__main__":
    from graphblas_tpu_torch.examples import cli_device
    dev = cli_device(__doc__)
    gt.init()
    gt.set_option("burble", True)
    r = main(dev)
    print(f"graph: {r['graph']}")
    print(f"GrB-tier BFS: reached {r['reached']} vertices, "
          f"max level {r['max_level']}")
    print(f"fused-tier BFS agrees: {r['fused_agrees']}")
    print(f"parent tree entries: {r['parent_entries']}")
