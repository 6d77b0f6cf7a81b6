"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (see ``affinity.py``).  Kernels are built on first use."""
from .affinity import fused_affinity_sym, fused_affinity_sym_plain
from .knn_topk import fused_knn, fused_knn_plain

__all__ = ["fused_affinity_sym", "fused_affinity_sym_plain", "fused_knn",
           "fused_knn_plain"]
