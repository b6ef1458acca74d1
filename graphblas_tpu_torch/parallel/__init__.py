"""The distributed tier on torch.distributed (counterpart of
``graphblas_tpu.parallel``): ``dist`` holds the ops, ``launch`` starts
the ranks."""

from .dist import (DistMatrix, DistMatrix2D, dist_bfs_levels, dist_mxm,
                   dist_mxv, dist_mxv_2d, dist_pagerank,
                   dist_reduce_scalar, dist_vxm, load_sharded, make_mesh,
                   make_mesh_2d, save_sharded)
