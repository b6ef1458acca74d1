"""Torch twins of ``__graft_entry__``'s entry points.

``entry(device)``: one PageRank power-iteration step (plus-times SpMV +
teleport) over a CSR graph, the BASELINE.json config-2 kernel.  Returns
``(pagerank_step, (r0, srcs, segs, outdeg))`` with the same arrays as the
JAX entry point, as tensors on ``device`` (default the card; see
``config.default_device``).

``dryrun_multichip(n_devices, device)``: the distributed tier's whole
sequence on ``n_devices`` spawned ranks (``parallel.launch.spawn``): NCCL
ranks on the cards, gloo ranks with ``device="cpu"``.
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


def _dryrun_rank(rank, world_size, device, ckpt):
    """One rank of ``dryrun_multichip``: the JAX dry run's sequence on
    ``_small_graph(n=256, deg=6, seed=1)``; every result is forced to the
    host."""
    from . import Matrix
    from . import parallel as par
    from .core import ops as OPS

    S = _small_graph(n=256, deg=6, seed=1)
    A = Matrix.from_scipy(S.astype(np.float32), device=device)
    mesh = par.make_mesh(world_size)
    D = par.DistMatrix.from_matrix(A, mesh)
    ones = np.ones(A.nrows, np.float32)
    par.dist_pagerank(D, max_iter=1).cpu()
    par.dist_bfs_levels(D, 0).cpu()
    par.dist_mxv(D, ones).cpu()
    par.dist_mxv(D, ones, overlap=True).cpu()
    m = (np.arange(A.nrows) % 2) == 0
    par.dist_mxv(D, ones, mask=m, accum=OPS.PLUS, c=ones).cpu()
    DC = par.dist_mxm(D, D)
    DC.values.cpu()
    par.save_sharded(DC, ckpt)
    par.load_sharded(ckpt, mesh).values.cpu()
    if world_size >= 4 and world_size % 2 == 0:
        mesh2 = par.make_mesh_2d(2, world_size // 2)
        D2 = par.DistMatrix2D.from_matrix(A, mesh2)
        par.dist_mxv_2d(D2, np.ones(A.ncols, np.float32)).cpu()
    return rank


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Twin of ``__graft_entry__.dryrun_multichip``: PageRank (one
    iteration), BFS, ``dist_mxv`` plain, on the ring and masked with
    accum, ``dist_mxm``, a sharded checkpoint round trip and (for an even
    world of 4 or more) the 2-D mxv, on ``n_devices`` spawned ranks.  On
    the cards (the default) each rank takes one, and more ranks than
    cards raises; ``device="cpu"`` runs gloo ranks."""
    import tempfile

    from .core.config import default_device
    from .parallel import launch

    dev = default_device(device)
    if dev.type == "cuda" and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}): this host has "
                         f"{torch.cuda.device_count()} CUDA cards")
    with tempfile.TemporaryDirectory(prefix="gbt_dryrun_") as ckpt:
        launch.spawn(_dryrun_rank, n_devices, dev.type, ckpt)
