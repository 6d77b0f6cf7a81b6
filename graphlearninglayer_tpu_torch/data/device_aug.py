"""Image augmentation on the device, for the device-resident data path.

Twin of ``graphlearninglayer_tpu/data/device_aug.py``.  The host pipeline
(``data/augment.py``, ``data/native/augment.cpp``) augments on the CPU and
copies each uint8 batch to the card; with ``--device_data`` the uint8
training set is copied to the card once, and each step gathers its rows and
augments them there, so a step copies only index and label vectors.

Per-op semantics are the PIL semantics that the native backend encodes
(``data/native/augment.cpp``, bit-exact with PIL):

* affine / rotate: nearest sample at output pixel centers (x+0.5, y+0.5),
  floor to the source pixel, zero fill out of bounds;
* enhance blends (brightness / color / contrast / sharpness): truncation
  toward zero of ``deg + (img - deg) * v``;
* L conversion: ``(R*19595 + G*38470 + B*7471 + 0x8000) >> 16``;
* contrast mean: round-half-up of the L mean;
* SMOOTH filter (sharpness degenerate): round-half-up, borders copied;
* autocontrast: per-channel linear LUT with truncation;
* equalize: PIL step formula (integer divisions), clamped at 255;
* solarize: float threshold, invert at >= threshold;
* posterize: bit mask;
* cutout: inclusive rectangle, gray fill (125, 123, 114) / 125.

How it is computed:

* Batch math runs on a planar (B, C, H*W) int32 layout; uint8 is promoted
  before any arithmetic.
* A warp is a gather: one source index per output pixel and a validity
  mask (zero fill).  The geometric prefix rotate -> flip -> pad+crop is one
  resample: flip and pad+crop are integer maps, so evaluating the
  rotation's affine at the positions they ask for equals the three
  resamples in sequence.
* brightness / contrast / solarize / posterize / autocontrast are closed
  form in the pixel level and applied per pixel; equalize builds its table
  from a per-image, per-channel histogram (``scatter_add_``) and applies it
  with ``gather``.  The sharpness filter is a sum of shifted slices in
  integers (a convolution on the card may run in TF32).
* Coordinates and magnitudes are float64 on every device, so the card's
  output equals the CPU's and the native backend's double path.
* A RandAugment round computes every op class for the whole batch and
  selects per image; there is no per-image Python loop.
* Random parameters are drawn by :meth:`DeviceTransform.draw`, one batched
  draw per parameter from a ``torch.Generator`` on the batch's device, and
  applied by :meth:`DeviceTransform.apply`; the streams differ from the JAX
  package's and the native backend's, so parity is per op at the same
  parameters.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .datasets import CHANNEL_STATS

__all__ = ["DeviceTransform", "device_apply_op", "OP_IDS", "device_rotate",
           "device_mirror", "device_pad_crop", "device_cutout"]

# op ids of data/native.py and augment.cpp (the reference's augment list)
OP_IDS = {
    "autocontrast": 0, "brightness": 1, "color": 2, "contrast": 3,
    "equalize": 4, "identity": 5, "posterize": 6, "rotate": 7,
    "sharpness": 8, "shear_x": 9, "shear_y": 10, "solarize": 11,
    "translate_x": 12, "translate_y": 13,
}
_NUM_OPS = 14
# magnitude ranges as float32 tables, read as float64 (the JAX twin's)
_OP_LO = np.array([0, 0.05, 0.05, 0.05, 0, 0, 4, 0, 0.05, 0, 0, 0, 0, 0],
                  np.float32)
_OP_HI = np.array([1, 0.95, 0.95, 0.95, 1, 1, 8, 30, 0.95, 0.3, 0.3, 256,
                   0.3, 0.3], np.float32)
# the geometric ops flip their magnitude's sign with p=1/2
_OP_SIGNED = np.zeros(_NUM_OPS, bool)
_OP_SIGNED[[7, 9, 10, 12, 13]] = True
_F64 = torch.float64


# --------------------------------------------------------------------------
# layout
# --------------------------------------------------------------------------

def _to_planar(batch_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, C, H*W) int32."""
    b, h, w, c = batch_u8.shape
    return batch_u8.to(torch.int32).permute(0, 3, 1, 2).reshape(b, c, h * w)


def _from_planar(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, C, H*W) int32 in [0, 255] -> (B, H, W, C) uint8."""
    b, c, _ = x.shape
    return (x.reshape(b, c, h, w).permute(0, 2, 3, 1).to(torch.uint8)
            .contiguous())


def _xi_yi(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat pixel coordinates: (P,) column and row indices."""
    p = torch.arange(h * w, dtype=torch.int32, device=device)
    return p % w, p // w


# --------------------------------------------------------------------------
# warp: per-image source map -> resampled image
# --------------------------------------------------------------------------

def _warp(x: torch.Tensor, src: torch.Tensor,
          valid: torch.Tensor) -> torch.Tensor:
    """out[b, c, p] = x[b, c, src[b, p]] where valid[b, p], else 0."""
    idx = src.long().unsqueeze(1).expand(-1, x.shape[1], -1)
    return torch.where(valid.unsqueeze(1), torch.gather(x, 2, idx), 0)


def _rotate_coeffs(h: int, w: int, deg: torch.Tensor) -> tuple:
    """PIL ``Image.rotate(angle)``: counter-clockwise about (w/2, h/2).
    ``deg``: (B,) degrees.  Returns the six (B,) affine coefficients."""
    ang = -deg.to(_F64) * (math.pi / 180.0)
    cs, sn = torch.cos(ang), torch.sin(ang)
    cx, cy = w / 2.0, h / 2.0
    a, b, d, e = cs, sn, -sn, cs
    c0 = cx - a * cx - b * cy
    f0 = cy - d * cx - e * cy
    return a, b, c0, d, e, f0


def _affine_src(h: int, w: int, coeffs, qx: torch.Tensor,
                qy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a per-image affine map at integer positions (qx, qy): the
    output pixel reads source floor(a*(qx+.5) + b*(qy+.5) + c0), ... (PIL
    ``Image.transform(AFFINE, nearest)``).  coeffs: six (B,) tensors; qx,
    qy: (B, P).  Returns flat source indices (B, P) (clipped) and the
    in-bounds mask (B, P)."""
    a, b, c0, d, e, f0 = [v.to(_F64)[:, None] for v in coeffs]
    xc = qx.to(_F64) + 0.5
    yc = qy.to(_F64) + 0.5
    ix = torch.floor(a * xc + b * yc + c0).to(torch.int32)
    iy = torch.floor(d * xc + e * yc + f0).to(torch.int32)
    valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    src = iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)
    return src, valid


def _prefix_src(h: int, w: int, n: int, ang, do_flip, off, *, rotation: int,
                flip: bool, pad: int, pad_reflect: bool, device):
    """Source map of the composed [rotate] -> [flip] -> pad+crop prefix.
    ``ang`` (B,) degrees, ``do_flip`` (B,) bool, ``off`` (B, 2) crop
    offsets (row, column) in [0, 2*pad]; each is read only when its stage
    is on.  Returns (src (B, P), valid (B, P))."""
    xi, yi = _xi_yi(h, w, device)
    qx = xi.expand(n, -1)
    qy = yi.expand(n, -1)
    valid = torch.ones((n, h * w), dtype=torch.bool, device=device)
    if pad > 0:
        qy = qy + (off[:, 0:1] - pad)
        qx = qx + (off[:, 1:2] - pad)
        if pad_reflect:
            qy = qy.abs()
            qy = torch.where(qy >= h, 2 * h - 2 - qy, qy)
            qx = qx.abs()
            qx = torch.where(qx >= w, 2 * w - 2 - qx, qx)
        else:
            valid = (qx >= 0) & (qx < w) & (qy >= 0) & (qy < h)
    if flip:
        qx = torch.where(do_flip[:, None], w - 1 - qx, qx)
    if rotation > 0:
        src, rot_valid = _affine_src(h, w, _rotate_coeffs(h, w, ang),
                                     qx.clamp(0, w - 1), qy.clamp(0, h - 1))
        # outside the constant-pad box the pixel is 0 whatever the rotation
        return src, valid & rot_valid
    return qy.clamp(0, h - 1) * w + qx.clamp(0, w - 1), valid


# --------------------------------------------------------------------------
# pixel ops on the planar batch
# --------------------------------------------------------------------------

def _lum_planar(x: torch.Tensor) -> torch.Tensor:
    """PIL 'L' conversion of int32 RGB: (B, 3, P) -> (B, P)."""
    return (x[:, 0] * 19595 + x[:, 1] * 38470 + x[:, 2] * 7471
            + 0x8000) >> 16


def _gray_planar(x: torch.Tensor) -> torch.Tensor:
    """The per-image L plane: (B, C, P) -> (B, P)."""
    return _lum_planar(x) if x.shape[1] == 3 else x[:, 0]


def _blend(deg, img: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """PIL ImageEnhance blend, float64: truncation toward zero, clamped."""
    r = deg + (img - deg) * v
    return torch.trunc(r).clamp(0, 255).to(torch.int32)


def _equalize_planar(x: torch.Tensor) -> torch.Tensor:
    """PIL equalize per image and channel: a 256-bin histogram, the step
    formula's table (integer divisions of non-negative counts; entry v
    uses the exclusive prefix sum), applied by ``gather``."""
    b, c, npix = x.shape
    xl = x.long()
    hist = torch.zeros((b, c, 256), dtype=torch.int64, device=x.device)
    hist.scatter_add_(2, xl, torch.ones_like(xl))
    levels = torch.arange(256, device=x.device)
    nzmask = hist > 0
    nz = nzmask.sum(-1)
    last_idx = torch.where(nzmask, levels, 0).amax(-1, keepdim=True)
    last_nz = hist.gather(2, last_idx)[..., 0]
    step = torch.where(nz <= 1, 0, (npix - last_nz) // 255)[..., None]
    cum_ex = hist.cumsum(-1) - hist
    lut = ((step // 2 + cum_ex) // step.clamp(min=1)).clamp(max=255)
    lut = torch.where(step == 0, levels, lut)
    return lut.gather(2, xl).to(torch.int32)


def _contrast_mean(x: torch.Tensor) -> torch.Tensor:
    """Round-half-up mean of the L plane: (B, C, P) -> (B,) float64."""
    lum = _gray_planar(x)
    return torch.floor(lum.sum(-1).to(_F64) / lum.shape[-1] + 0.5)


def _sharpness_planar(x: torch.Tensor, v: torch.Tensor, h: int,
                      w: int) -> torch.Tensor:
    """Blend toward the PIL SMOOTH filter (3x3 [1 1 1; 1 5 1; 1 1 1] / 13,
    round-half-up, border pixels copied).  v: (B,)."""
    b, c, p = x.shape
    img = x.reshape(b * c, h, w)
    acc = (img[:, :-2, :-2] + img[:, :-2, 1:-1] + img[:, :-2, 2:]
           + img[:, 1:-1, :-2] + 5 * img[:, 1:-1, 1:-1] + img[:, 1:-1, 2:]
           + img[:, 2:, :-2] + img[:, 2:, 1:-1] + img[:, 2:, 2:])
    deg = img.to(_F64)
    deg[:, 1:-1, 1:-1] = torch.floor(acc.to(_F64) / 13.0 + 0.5).clamp(0, 255)
    return _blend(deg.reshape(b, c, p), x.to(_F64), v.to(_F64)[:, None, None])


def _cutout_planar(x: torch.Tensor, frac: torch.Tensor, r1: torch.Tensor,
                   r2: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Gray square, the inclusive rectangle of PIL ``ImageDraw.rectangle``
    at truncated corners.  frac / r1 / r2: (B,)."""
    b, c, p = x.shape
    v = frac.to(_F64) * w
    x0 = (r1.to(_F64) * w - v / 2.0).clamp(min=0.0)
    y0 = (r2.to(_F64) * h - v / 2.0).clamp(min=0.0)
    ix0, iy0 = x0.to(torch.int32), y0.to(torch.int32)
    ix1 = (x0 + v).clamp(max=float(w)).to(torch.int32).clamp(max=w - 1)
    iy1 = (y0 + v).clamp(max=float(h)).to(torch.int32).clamp(max=h - 1)
    xi, yi = _xi_yi(h, w, x.device)
    mask = ((yi >= iy0[:, None]) & (yi <= iy1[:, None])
            & (xi >= ix0[:, None]) & (xi <= ix1[:, None])
            & (frac > 0)[:, None])
    # gray (125, 123, 114), or 125 on one channel; built on the device
    ch = torch.arange(c, dtype=torch.int32, device=x.device)
    fill = torch.where(ch == 0, 125, torch.where(ch == 1, 123, 114))
    return torch.where(mask[:, None, :], fill[None, :, None], x)


def _round_planar(x: torch.Tensor, op: torch.Tensor, v: torch.Tensor,
                  sv: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """One RandAugment op per image on a (B, C, P) int32 batch.  op (B,)
    op ids; v (B,) magnitude; sv (B,) the magnitude with its sign, which
    the geometric ops use.  Every op class is computed for the whole batch
    and selected per image."""
    b, c, p = x.shape
    xf = x.to(_F64)
    vf = v.to(_F64)
    vb = vf[:, None, None]
    opb = op[:, None, None]

    out = x  # identity (op 5)

    # autocontrast (0): per-channel linear stretch between the channel's
    # min and max, truncated
    lo = x.amin(2, keepdim=True).to(_F64)
    hi = x.amax(2, keepdim=True).to(_F64)
    # a true division: ``scalar / tensor`` multiplies by the reciprocal
    scale = torch.full_like(hi, 255.0) / (hi - lo).clamp(min=1.0)
    ac = torch.trunc(xf * scale + (-lo * scale)).clamp(0, 255)
    ac = torch.where(hi <= lo, x, ac.to(torch.int32))
    out = torch.where(opb == 0, ac, out)

    # brightness (1): blend toward black
    out = torch.where(opb == 1, _blend(0.0, xf, vb), out)

    # color (2): blend toward the L plane; the identity on grayscale
    if c == 3:
        deg = _lum_planar(x).to(_F64)[:, None, :]
        out = torch.where(opb == 2, _blend(deg, xf, vb), out)

    # contrast (3): blend toward the round-half-up L mean
    mean = _contrast_mean(x)[:, None, None]
    out = torch.where(opb == 3, _blend(mean, xf, vb), out)

    # equalize (4)
    out = torch.where(opb == 4, _equalize_planar(x), out)

    # posterize (6): keep the top `bits` bits
    bits = vf.to(torch.int32).clamp(1, 8)
    low = torch.bitwise_left_shift(torch.ones_like(bits), 8 - bits) - 1
    pmask = torch.bitwise_not(low) & 255
    out = torch.where(opb == 6, x & pmask[:, None, None], out)

    # sharpness (8): blend toward SMOOTH
    out = torch.where(opb == 8, _sharpness_planar(x, vf, h, w), out)

    # solarize (11): invert at >= threshold
    out = torch.where(opb == 11, torch.where(xf < vb, x, 255 - x), out)

    # the geometric class (7 / 9 / 10 / 12 / 13): one affine resample whose
    # coefficients are selected per image
    svf = sv.to(_F64)
    zero, one = torch.zeros_like(svf), torch.ones_like(svf)
    geo_tbl = {
        9: (one, svf, zero, zero, one, zero),             # shear_x
        10: (one, zero, zero, svf, one, zero),            # shear_y
        12: (one, zero, svf * w, zero, one, zero),        # translate_x
        13: (one, zero, zero, zero, one, svf * h),        # translate_y
    }
    coeffs = _rotate_coeffs(h, w, svf)
    for op_id, cf in geo_tbl.items():
        coeffs = tuple(torch.where(op == op_id, new, cur)
                       for new, cur in zip(cf, coeffs))
    xi, yi = _xi_yi(h, w, x.device)
    src, valid = _affine_src(h, w, coeffs, xi.expand(b, -1),
                             yi.expand(b, -1))
    is_geo = (op == 7) | (op == 9) | (op == 10) | (op == 12) | (op == 13)
    return torch.where(is_geo[:, None, None], _warp(x, src, valid), out)


# --------------------------------------------------------------------------
# single-image functions (the per-op interface the native backend also
# exposes); each runs on the image's device
# --------------------------------------------------------------------------

def _as_image(img_u8) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(img_u8)
                           if isinstance(img_u8, np.ndarray) else img_u8)


def device_apply_op(img_u8, op: int, v: float, sign: bool) -> torch.Tensor:
    """One RandAugment op on one (H, W, C) uint8 image, at magnitude ``v``
    with ``sign`` flipping the geometric ops' direction (native
    ``gll_apply_op``)."""
    img = _as_image(img_u8)
    h, w, _ = img.shape
    dev = img.device
    opt = torch.tensor([int(op)], device=dev)
    vt = torch.tensor([float(v)], dtype=_F64, device=dev)
    out = _round_planar(_to_planar(img[None]), opt, vt,
                        -vt if sign else vt, h, w)
    return _from_planar(out, h, w)[0]


def device_rotate(img_u8, deg: float) -> torch.Tensor:
    """PIL ``Image.rotate(deg)`` (nearest, zero fill) of one image."""
    img = _as_image(img_u8)
    h, w, _ = img.shape
    xi, yi = _xi_yi(h, w, img.device)
    deg_t = torch.tensor([float(deg)], dtype=_F64, device=img.device)
    src, valid = _affine_src(h, w, _rotate_coeffs(h, w, deg_t), xi[None],
                             yi[None])
    return _from_planar(_warp(_to_planar(img[None]), src, valid), h, w)[0]


def device_mirror(img_u8) -> torch.Tensor:
    """Left-right mirror of one (H, W, C) image."""
    return _as_image(img_u8).flip(1)


def device_pad_crop(img_u8, pad: int, reflect: bool, i: int,
                    j: int) -> torch.Tensor:
    """numpy-style pad (zeros, or reflect without edge repeat) by ``pad``,
    then the (H, W) crop at row ``i``, column ``j``."""
    img = _as_image(img_u8)
    h, w, _ = img.shape
    off = torch.tensor([[int(i), int(j)]], device=img.device)
    src, valid = _prefix_src(h, w, 1, None, None, off, rotation=0,
                             flip=False, pad=pad, pad_reflect=reflect,
                             device=img.device)
    return _from_planar(_warp(_to_planar(img[None]), src, valid), h, w)[0]


def device_cutout(img_u8, frac: float, r1: float, r2: float) -> torch.Tensor:
    """The cutout square of side ``frac`` * W centered at (r1 * W, r2 * H)
    on one image."""
    img = _as_image(img_u8)
    h, w, _ = img.shape
    t = lambda a: torch.tensor([float(a)], dtype=_F64, device=img.device)
    out = _cutout_planar(_to_planar(img[None]), t(frac), t(r1), t(r2), h, w)
    return _from_planar(out, h, w)[0]


# --------------------------------------------------------------------------
# the batch transform
# --------------------------------------------------------------------------

class DeviceTransform:
    """Per-dataset weak / strong / eval transform on the batch's device,
    the counterpart of ``data/augment.py::Transform`` (same mode
    semantics).

    ``transform(batch_u8, generator)`` maps a (B, H, W, C) uint8 tensor to
    an augmented uint8 tensor of the same shape on the same device; the
    per-image parameters come from ``generator`` (a ``torch.Generator`` on
    that device, or the device's default generator when None).  It is
    ``apply(batch_u8, draw(B, generator, device))``; a caller may draw the
    parameters itself.  Eval mode is the identity (the train step
    normalizes)."""

    def __init__(self, dataset: str, mode: str = "eval"):
        if mode not in ("weak", "strong", "eval"):
            raise ValueError(f"unknown mode {mode!r}")
        self.dataset = dataset
        self.mode = mode
        self.mean, self.std = CHANNEL_STATS[dataset]
        grayscale = dataset in ("mnist", "fashion_mnist", "synthetic")
        self.grayscale = grayscale
        self.rand_n = 0 if mode == "eval" else (1 if mode == "weak" else 2)
        self.rotation = (10 if mode == "weak" else 20) if grayscale else 0
        self.flip = not grayscale and mode != "eval"
        pad = 8 if dataset == "miniimagenet" else 4
        self.pad = pad if mode != "eval" else 0
        self.pad_reflect = not grayscale
        self._tables: dict = {}   # device -> (lo, hi, signed) op tables

    @property
    def is_eval(self) -> bool:
        return self.mode == "eval"

    def draw(self, n: int, generator: torch.Generator | None = None,
             device=None) -> dict:
        """The random parameters of ``n`` images, one batched draw each:
        ``ang`` (n,) rotation degrees (with rotation), ``do_flip`` (n,)
        (with flip), ``off`` (n, 2) crop offsets (with padding),
        ``rounds`` a list of (op, v, sv) per RandAugment round, and
        ``cutout`` (frac, r1, r2); magnitudes in float64."""
        dev = torch.device(device) if device is not None else (
            generator.device if generator is not None
            else torch.device("cpu"))
        uni = lambda *shape: torch.rand(shape, dtype=_F64,
                                        generator=generator, device=dev)
        params: dict = {}
        if self.rotation > 0:
            params["ang"] = (uni(n) * 2.0 - 1.0) * self.rotation
        if self.flip:
            params["do_flip"] = uni(n) < 0.5
        if self.pad > 0:
            params["off"] = torch.randint(0, 2 * self.pad + 1, (n, 2),
                                          generator=generator, device=dev)
        if dev not in self._tables:   # copied to the device once
            self._tables[dev] = (torch.from_numpy(_OP_LO).to(dev, _F64),
                                 torch.from_numpy(_OP_HI).to(dev, _F64),
                                 torch.from_numpy(_OP_SIGNED).to(dev))
        lo_t, hi_t, signed_t = self._tables[dev]
        rounds = []
        for _ in range(self.rand_n):
            op = torch.randint(0, _NUM_OPS, (n,), generator=generator,
                               device=dev)
            u, neg = uni(n), uni(n) > 0.5
            v = u * (hi_t[op] - lo_t[op]) + lo_t[op]
            rounds.append((op, v, torch.where(signed_t[op] & neg, -v, v)))
        params["rounds"] = rounds
        ucut = uni(n, 3)
        params["cutout"] = (ucut[:, 0] * 0.5, ucut[:, 1], ucut[:, 2])
        return params

    def apply(self, batch_u8: torch.Tensor, params: dict) -> torch.Tensor:
        """Augment ``batch_u8`` with the drawn ``params``: [rotate] ->
        [flip] -> pad+crop as one resample, the RandAugment rounds, then
        the always-applied cutout."""
        if self.is_eval:
            return batch_u8
        n, h, w, _ = batch_u8.shape
        x = _to_planar(batch_u8)
        if self.pad > 0 or self.rotation > 0 or self.flip:
            src, valid = _prefix_src(
                h, w, n, params.get("ang"), params.get("do_flip"),
                params.get("off"), rotation=self.rotation, flip=self.flip,
                pad=self.pad, pad_reflect=self.pad_reflect,
                device=batch_u8.device)
            x = _warp(x, src, valid)
        for op, v, sv in params["rounds"]:
            x = _round_planar(x, op, v, sv, h, w)
        x = _cutout_planar(x, *params["cutout"], h, w)
        return _from_planar(x, h, w)

    def __call__(self, batch_u8: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        if self.is_eval:
            return batch_u8
        return self.apply(batch_u8, self.draw(len(batch_u8), generator,
                                              batch_u8.device))
