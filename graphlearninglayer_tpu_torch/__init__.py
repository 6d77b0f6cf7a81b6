"""PyTorch + CUDA port of ``graphlearninglayer_tpu`` for one NVIDIA H100.

Same sub-package layout and public names as the JAX package, which stays
the reference the port is tested against.  This package imports torch and
numpy only.  Its entry points run on the card unless the caller passes
``device="cpu"``.
"""
