from .graph import (bfs_levels, bfs_levels_fused, bfs_parents,
                    connected_components, pagerank, pagerank_fused, sssp,
                    sssp_grb, triangle_count)

__all__ = ["bfs_levels", "bfs_levels_fused", "bfs_parents",
           "connected_components", "pagerank", "pagerank_fused", "sssp",
           "sssp_grb", "triangle_count"]
