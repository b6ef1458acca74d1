"""Kronecker-product graph generator demo — the reference's
Demo/Program/kron analog (build large power-law-ish graphs as repeated
GrB_kronecker of a small seed).
Run: python -m graphblas_tpu_torch.examples.kron_demo"""

import numpy as np

import graphblas_tpu_torch as gt

SEED = ([0, 0, 1, 2, 2], [0, 1, 2, 0, 2])     # 3x3, self-similar


def main(device=None, levels: int = 3, verbose: bool = False) -> dict:
    seed = gt.Matrix.from_coo(*SEED, [1.0] * 5, (3, 3), device=device)
    G = seed
    for level in range(levels):
        G = gt.kronecker(G, seed, gt.operators.TIMES)
        if verbose:
            print(f"level {level + 1}: {G!r}")
    r, _, _ = G.coo()
    deg = np.bincount(r.cpu().numpy(), minlength=G.nrows)
    return {"graph": G, "nrows": G.nrows, "nvals": G.nvals,
            "max_out_degree": int(deg.max()),
            "empty_rows": int((deg == 0).sum())}


if __name__ == "__main__":
    from graphblas_tpu_torch.examples import cli_device
    dev = cli_device(__doc__)
    gt.init()
    gt.set_option("burble", True)
    r = main(dev, verbose=True)
    print("final graph:", r["nrows"], "vertices,", r["nvals"], "edges")
    print("max out-degree:", r["max_out_degree"], " empty rows:",
          r["empty_rows"])
