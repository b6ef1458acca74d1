from .graph import (bfs_levels, bfs_levels_fused, pagerank, pagerank_fused,
                    sssp, triangle_count)

__all__ = ["bfs_levels", "bfs_levels_fused", "pagerank", "pagerank_fused",
           "sssp", "triangle_count"]
