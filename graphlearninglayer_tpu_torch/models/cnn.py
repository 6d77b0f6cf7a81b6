"""Small model helpers shared by the encoders."""
from __future__ import annotations

import torch

__all__ = ["l2_normalize"]


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """torch F.normalize semantics: x / max(||x||, eps).

    Written via max *inside* the sqrt so the gradient at x = 0 is finite
    (the identity over eps) instead of NaN.
    """
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(sq.clamp_min(eps * eps))
