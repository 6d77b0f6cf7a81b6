"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (see ``affinity.py``).  Kernels are built on first use.  The
modules ``row_sort`` and ``take_along`` (P1, P2) hold kernels that no path
calls; their functions are not exported here, where their names would
hide the modules."""
from .affinity import fused_affinity_sym, fused_affinity_sym_plain
from .ell_spmm import ell_gather_spmm, ell_gather_spmm_plain
from .knn_topk import fused_knn, fused_knn_plain

__all__ = ["fused_affinity_sym", "fused_affinity_sym_plain", "fused_knn",
           "fused_knn_plain", "ell_gather_spmm", "ell_gather_spmm_plain"]
