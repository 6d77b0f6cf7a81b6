"""Work counts from shapes: the yardstick of the rooflines and of `mfu`.

Every count is of the function's own work at the cell's shapes, not of what
an implementation happens to do:

* a convolution or linear layer costs 2 x MACs a pass; a train step runs
  its forward, its input gradient and its weight gradient (the first
  convolution has no input gradient: the images need none), PGD's input
  gradient runs forward and input gradient only, with the first
  convolution's input gradient included;
* a kernel's bytes are each input read once and each output written once.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit:
3.35 TB/s of HBM, 67 TFLOP/s of float32 outside the tensor cores and 495
TFLOP/s of TF32 (dense).  The encoder's work is taken against the TF32 peak,
because cuDNN runs its convolutions in TF32; the exact KNN's against the
float32 peak, as its kernel computes in float32 FMA.  An encoder's layers
and their MACs come from its file under ``encoders/``.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_TF32_FLOP_PER_S = 495e12


def forward_macs(layers) -> int:
    """MACs of one image's forward pass, from an encoder's ``layers(cfg)``
    ((name, MACs an image), the stem first)."""
    return sum(m for _, m in layers)


def train_step_flops(images: int, layers) -> float:
    """FLOPs of one train step over ``images`` rows: forward, weight
    gradient and input gradient of every layer but the stem's input
    gradient."""
    return 2.0 * images * (3 * forward_macs(layers) - layers[0][1])


def input_grad_flops(images: int, layers) -> float:
    """FLOPs of one gradient of the loss with respect to the images over
    ``images`` rows: forward and input gradient of every layer, the stem's
    included, and no weight gradient."""
    return 2.0 * images * 2 * forward_macs(layers)


def forward_flops(images: int, layers) -> float:
    """FLOPs of the forward pass over ``images`` rows."""
    return 2.0 * images * forward_macs(layers)


def knn_one_triangle_flops(n: int, d: int) -> float:
    """The exact KNN's dot products over the Gram matrix's upper triangle,
    self included: n (n + 1) / 2 d FMA of two operations each."""
    return float(n) * (n + 1) * d


def k1_bound_ms(n: int, d: int) -> tuple[float, str]:
    """Least time for K1 (the dense op's masked affinity): x (n, d), eps (n,)
    and the raw KNN indicator M (n, n) read once, W (n, n) written once, all
    float32; its dot products n (n + 1) d over the Gram matrix's upper
    triangle at the most.  Returns (ms, the bound that binds)."""
    nbytes = 4 * (n * d + n + n * n) + 4 * n * n
    ops = float(n) * (n + 1) * d
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def k2_bound_ms(n: int, d: int, k: int) -> tuple[float, str]:
    """Least time for K2 (the eval's exact KNN): the Gram matrix's upper
    triangle in float32 FMA against x read once and the (n, k) int64 lists
    and float32 distances written once.  Returns (ms, the bound that
    binds)."""
    nbytes = 4 * n * d + (8 + 4) * n * k
    ops = knn_one_triangle_flops(n, d)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_FLOP_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")
