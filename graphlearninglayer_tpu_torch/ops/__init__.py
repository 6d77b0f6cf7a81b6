from .knn import knn, knn_tiled, pairwise_dist2
from .graph import (BatchGraph, build_graph, dense_weight_matrix,
                    edge_weights, sym_rowsum, sym_spmm)
from .dense_mode import (DenseGraph, build_dense_graph, dense_affinity,
                         dense_backward, dense_forward)
from .solve import (CholeskyFactor, cholesky_factor, cholesky_solve,
                    stable_conjgrad)
from .laplace import (GRAD_NORM_WARN_THRESHOLD, LaplaceConfig,
                      laplace_learning, warn_exploding_grad)
from .transductive import (EvalGraphCache, one_hot_encode,
                           transductive_laplace)

__all__ = [
    "knn", "knn_tiled", "pairwise_dist2",
    "BatchGraph", "build_graph", "dense_weight_matrix", "edge_weights",
    "sym_rowsum", "sym_spmm",
    "DenseGraph", "build_dense_graph", "dense_affinity", "dense_backward",
    "dense_forward",
    "CholeskyFactor", "cholesky_factor", "cholesky_solve", "stable_conjgrad",
    "GRAD_NORM_WARN_THRESHOLD", "LaplaceConfig", "laplace_learning",
    "warn_exploding_grad",
    "EvalGraphCache", "one_hot_encode", "transductive_laplace",
]
