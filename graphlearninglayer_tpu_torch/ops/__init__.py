from .knn import knn, pairwise_dist2
from .dense_mode import (DenseGraph, build_dense_graph, dense_affinity,
                         dense_backward, dense_forward)
from .solve import CholeskyFactor, cholesky_factor, cholesky_solve
from .laplace import (GRAD_NORM_WARN_THRESHOLD, LaplaceConfig,
                      laplace_learning, warn_exploding_grad)

__all__ = [
    "knn", "pairwise_dist2",
    "DenseGraph", "build_dense_graph", "dense_affinity", "dense_backward",
    "dense_forward",
    "CholeskyFactor", "cholesky_factor", "cholesky_solve",
    "GRAD_NORM_WARN_THRESHOLD", "LaplaceConfig", "laplace_learning",
    "warn_exploding_grad",
]
