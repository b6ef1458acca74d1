"""bfsp_products (layer "op layer"): products per BFS parent tree that the
program's sparse-times-bitmap product expands, by its own counter
``mxm.spmm_products`` (the matrix's stored entries times the bitmap's
columns, once a level)."""

from __future__ import annotations

from gbbench import bfs


def install(run):
    return bfs.install_counter(run, "mxm.spmm_products")
