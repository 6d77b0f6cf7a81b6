from .edge_shard import (build_edge_shard_plan, edge_sharded_solve,
                         edge_sharded_transductive_laplace, sharded_knn)
from .graph_shard import sharded_laplace_solve, sharded_transductive_laplace
from .mesh import (CrossRankBatchNorm2d, Mesh, RowShard, all_reduce_sum,
                   convert_cross_rank_bn, gather_rows, make_mesh)
from .multihost import (global_mesh, initialize_multihost, is_multihost,
                        rank_device, spawn_ranks)

__all__ = ["Mesh", "make_mesh", "gather_rows", "all_reduce_sum", "RowShard",
           "CrossRankBatchNorm2d", "convert_cross_rank_bn",
           "global_mesh", "initialize_multihost", "is_multihost",
           "rank_device", "spawn_ranks",
           "sharded_knn", "edge_sharded_transductive_laplace",
           "edge_sharded_solve", "build_edge_shard_plan",
           "sharded_laplace_solve", "sharded_transductive_laplace"]
