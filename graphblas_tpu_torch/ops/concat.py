"""GxB_Matrix_concat / GxB_Matrix_split (counterpart of
``graphblas_tpu.ops.concat``; reference: Source/GB_concat*.c,
GB_split*.c): tiles compose by offsetting their coordinates and one sort;
split is an extract over index ranges."""

from __future__ import annotations

import numpy as np
import torch

from ..core import config as CFG
from ..core import errors as E
from ..core import types as T
from ..core.matrix import INDEX, ROW, SPARSE, Matrix
from ..core.types import cast
from ..kernels import segment as K
from .extract import extract_pattern


def concat(tiles) -> Matrix:
    """``tiles``: a 2-D list of Matrix blocks (row-major), like
    GxB_Matrix_concat's m-by-n Tile array.  The result is SPARSE by row,
    of the first tile's type."""
    nrows_blocks = len(tiles)
    ncols_blocks = len(tiles[0])
    for row in tiles:
        if len(row) != ncols_blocks:
            raise E.DimensionMismatch("concat: ragged tile grid")
    row_sizes = [tiles[i][0].nrows for i in range(nrows_blocks)]
    col_sizes = [tiles[0][j].ncols for j in range(ncols_blocks)]
    for i, row in enumerate(tiles):
        for j, t in enumerate(row):
            if t.nrows != row_sizes[i] or t.ncols != col_sizes[j]:
                raise E.DimensionMismatch(
                    f"concat: tile ({i},{j}) shape {t.shape}")
    roff = np.concatenate([[0], np.cumsum(row_sizes)])
    coff = np.concatenate([[0], np.cumsum(col_sizes)])
    M, N = int(roff[-1]), int(coff[-1])
    dt = tiles[0][0].dtype
    CFG.burble("concat: %dx%d tiles -> %dx%d", nrows_blocks, ncols_blocks,
               M, N)
    rows_all, cols_all, vals_all = [], [], []
    for i, row in enumerate(tiles):
        for j, t in enumerate(row):
            r, c, v = t.coo()
            rows_all.append(r.long() + int(roff[i]))
            cols_all.append(c.long() + int(coff[j]))
            vals_all.append(T.bits(cast(v, dt)))
    rows = torch.cat(rows_all)
    cols = torch.cat(cols_all)
    vals = T.unbits(torch.cat(vals_all), dt.torch_dtype)
    order, skeys = K.sort_coo(rows, cols, N)
    svec, sidx = K.key_split(skeys, N)
    indptr = K.indptr_from_sorted(svec, M, INDEX)
    return Matrix((M, N), dt, SPARSE, ROW, indptr=indptr, indices=sidx,
                  values=T.take(vals, order))


def split(A: Matrix, row_sizes, col_sizes):
    """The inverse of concat: a 2-D list of tiles."""
    if sum(row_sizes) != A.nrows or sum(col_sizes) != A.ncols:
        raise E.DimensionMismatch("split: sizes must sum to matrix dims")
    roff = np.concatenate([[0], np.cumsum(row_sizes)]).astype(np.int64)
    coff = np.concatenate([[0], np.cumsum(col_sizes)]).astype(np.int64)
    return [[extract_pattern(A, np.arange(roff[i], roff[i + 1]),
                             np.arange(coff[j], coff[j + 1]))
             for j in range(len(col_sizes))]
            for i in range(len(row_sizes))]
