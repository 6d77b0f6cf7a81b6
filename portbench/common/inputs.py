"""Inputs and weights made from the seed, on the device, in a few large
calls: the same seed gives the same images, labels, orders and weights.
Both the program and the reference are handed these."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def synthetic_images(n: int, shape, classes: int, gen: torch.Generator,
                     device) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, H, W, C) uint8 images and (n,) int64 labels: each image is its
    class's smooth template (a 4 x 4 random field upsampled) mixed with
    per-pixel noise, so that classes differ and no two images coincide."""
    h, w, c = shape
    labels = torch.randint(classes, (n,), generator=gen, device=device)
    coarse = torch.rand((classes, c, 4, 4), generator=gen, device=device)
    templates = F.interpolate(coarse, size=(h, w), mode="bilinear",
                              align_corners=False)
    noise = torch.rand((n, c, h, w), generator=gen, device=device)
    img = (255.0 * (0.55 * templates[labels] + 0.45 * noise)).round_()
    img = img.clamp_(0, 255).to(torch.uint8)
    return img.permute(0, 2, 3, 1).contiguous(), labels


def normalize(images: torch.Tensor, mean, std) -> torch.Tensor:
    """uint8 NHWC -> float32 NHWC, (x / 255 - mean) / std per channel."""
    m = torch.as_tensor(mean, dtype=torch.float32, device=images.device)
    s = torch.as_tensor(std, dtype=torch.float32, device=images.device)
    return (images.float() / 255.0 - m) / s


def base_indices(labels: torch.Tensor, per_class: int, classes: int,
                 seed: int) -> torch.Tensor:
    """``per_class`` rows of each class, drawn from the seed (host numpy:
    a few thousand labels), as a device index vector in class order."""
    lab = labels.cpu().numpy()
    rng = np.random.default_rng(seed)
    rows = [rng.permutation(np.flatnonzero(lab == c))[:per_class]
            for c in range(classes)]
    if any(len(r) < per_class for r in rows):
        raise ValueError("too few images of a class for the base set")
    return torch.as_tensor(np.concatenate(rows), device=labels.device)


class FlatParams:
    """A model's parameters made from the seed in one flat float32 buffer,
    in the program model's order and names: conv and linear weights and
    biases uniform(-b, b) with b = 1 / sqrt(fan_in) (PyTorch's default
    bounds), batch-norm weights 1 and biases 0; and its buffers: running
    means 0, variances 1.

    ``params`` maps the parameter names to views of the flat buffer,
    ``buffers`` the buffer names to tensors; :meth:`load` copies both into
    a program model."""

    def __init__(self, model: torch.nn.Module, gen: torch.Generator, device):
        named = [(n, p) for n, p in model.named_parameters()]
        sizes = [p.numel() for _, p in named]
        self.flat = torch.rand(sum(sizes), generator=gen, device=device)
        self.scale = torch.empty_like(self.flat)
        self.params = {}
        bounds = {}
        for name, p in named:
            if p.dim() > 1:
                bounds[name.rsplit(".", 1)[0]] = 1.0 / math.sqrt(p[0].numel())
        for (name, p), view, s in zip(named, self.flat.split(sizes),
                                      self.scale.split(sizes)):
            view, s = view.view(p.shape), s.view(p.shape)
            layer, leaf = name.rsplit(".", 1)
            b = bounds.get(layer)
            if b is None:                  # batch norm
                view.fill_(1.0 if leaf == "weight" else 0.0)
                s.fill_(1.0)
            else:
                view.mul_(2.0 * b).sub_(b)
                s.fill_(b)
            self.params[name] = view
        self.buffers = {}
        for name, buf in model.named_buffers():
            if name.endswith("running_var"):
                self.buffers[name] = torch.ones(buf.shape, device=device)
            elif name.endswith("running_mean"):
                self.buffers[name] = torch.zeros(buf.shape, device=device)
            else:
                self.buffers[name] = torch.zeros(buf.shape, dtype=buf.dtype,
                                                 device=device)

    def all(self) -> dict:
        return {**self.params, **self.buffers}

    def drift(self, sigma: float, gen: torch.Generator) -> None:
        """Every parameter moves by sigma times its scale (its init bound;
        1 for batch norm) times a standard normal draw."""
        noise = torch.randn(self.flat.shape, generator=gen,
                            device=self.flat.device)
        self.flat.addcmul_(noise, self.scale, value=sigma)

    @torch.no_grad()
    def load(self, model: torch.nn.Module) -> None:
        state = model.state_dict()
        for name, t in self.all().items():
            state[name].copy_(t)
