"""Torch twin of ``__graft_entry__.entry()``: one PageRank power-iteration
step (plus-times SpMV + teleport) over a CSR graph, the BASELINE.json
config-2 kernel.

``entry(device)`` returns ``(pagerank_step, (r0, srcs, segs, outdeg))``
with the same arrays as the JAX entry point, as tensors on ``device``
(default the card; see ``config.default_device``).
"""

from __future__ import annotations

import numpy as np
import torch


def _small_graph(n=512, deg=8, seed=0):
    import scipy.sparse as sps
    rng = np.random.default_rng(seed)
    nnz = n * deg
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    S = sps.csr_matrix((np.ones(nnz, np.float32), (rows, cols)),
                       shape=(n, n))
    S.sum_duplicates()
    return S


def entry(device=None):
    from . import COL, ROW, SPARSE, Matrix
    from .core.config import default_device
    from .kernels import segment as K

    device = default_device(device)
    S = _small_graph()
    A = Matrix.from_scipy(S.astype(np.float32), device=device)
    At = A.to_format(SPARSE, COL)  # CSC == A' in CSR
    n = A.nrows
    outdeg = torch.diff(A.to_orient(ROW).indptr).to(torch.float32)
    nnz = int(At.indices.shape[0])
    segs = K.expand_rowids(At.indptr, nnz, n).long()
    srcs = At.indices.long()
    r0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)

    def pagerank_step(r, srcs, segs, outdeg):
        damping = 0.85
        safe = torch.where(outdeg > 0, outdeg, torch.ones_like(outdeg))
        rn = torch.zeros_like(r).index_add_(0, segs, (r / safe)[srcs])
        dang = torch.where(outdeg > 0, torch.zeros_like(r), r).sum()
        return damping * (rn + dang / n) + (1.0 - damping) / n

    return pagerank_step, (r0, srcs, segs, outdeg)
