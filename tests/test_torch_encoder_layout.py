"""The encoder's input layout (``models/buildnet.py::nhwc_input``): on CUDA
every 4-D input reaches the convolutions in NHWC strides, by a zero-copy
view for one channel and a channels_last copy for more; an input that is
NHWC already, and every CPU input, passes through as it is.

The CPU tests call the helper with ``cuda=True`` to cover its CUDA branch
without a card.  The card test runs one robust GL step of the robust
Fashion-MNIST geometry under the profiler and finds no cuDNN layout
transpose but around the one-channel stem.  This file imports neither JAX nor the
JAX package; on a machine without JAX:

    python -m pytest tests/test_torch_encoder_layout.py -m cuda --noconftest -q
"""
import re

import pytest
import torch
import torch.nn as nn
from torch.profiler import ProfilerActivity, profile

from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.models.buildnet import (encoder_layouts,
                                                          nhwc_input)
from graphlearninglayer_tpu_torch.models.cnn import l2_normalize

SHAPES = {"gray": (4, 1, 28, 28), "rgb": (4, 3, 32, 32)}


def _nchw(shape, seed=0, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype)


def _nhwc_view(shape, seed=0):
    """An NHWC-strided view of NCHW shape, as the FullySup step and the
    eval pass their batches: NHWC rows permuted."""
    n, c, h, w = shape
    return _nchw((n, h, w, c), seed).permute(0, 3, 1, 2)


def _is_nhwc(x):
    return x.stride(1) == 1 and x.is_contiguous(
        memory_format=torch.channels_last)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_contiguous_nchw_input_gets_nhwc_strides(shape):
    x = _nchw(SHAPES[shape])
    assert not _is_nhwc(x)
    y = nhwc_input(x, cuda=True)
    n, c, h, w = x.shape
    assert y.shape == x.shape
    assert y.stride() == (h * w * c, 1, w * c, c)
    # PyTorch itself reads them as channels_last: a convolution keeps them
    conv = nn.Conv2d(c, 8, 3, padding=1)
    assert _is_nhwc(conv(y)) and not _is_nhwc(conv(x))


def test_one_channel_trap():
    """A contiguous (N, 1, H, W) tensor counts as channels_last-contiguous,
    so ``contiguous(memory_format=channels_last)`` keeps its NCHW strides;
    the helper's view does not."""
    x = _nchw(SHAPES["gray"])
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert x.contiguous(memory_format=torch.channels_last).stride() \
        == x.stride()
    assert nhwc_input(x, cuda=True).stride() != x.stride()


@pytest.mark.parametrize("case", ["gray_nchw", "gray_nhwc", "rgb_nhwc"])
def test_no_copy(case):
    shape, layout = case.split("_")
    x = (_nchw if layout == "nchw" else _nhwc_view)(SHAPES[shape])
    y = nhwc_input(x, cuda=True)
    assert y.data_ptr() == x.data_ptr()
    if layout == "nhwc":
        assert y is x


@pytest.mark.parametrize("case", ["gray_nchw", "rgb_nchw", "rgb_nhwc"])
def test_values_and_input_gradient_are_unchanged(case):
    shape, layout = case.split("_")
    x = (_nchw if layout == "nchw" else _nhwc_view)(SHAPES[shape])
    wgt = _nchw(SHAPES[shape], seed=1)
    grads = []
    for restride in (False, True):
        xi = x.detach().clone(memory_format=torch.preserve_format)
        xi.requires_grad_(True)
        v = nhwc_input(xi, cuda=True) if restride else xi
        assert torch.equal(v, xi)
        (v * wgt).square().sum().backward()
        grads.append(xi.grad)
    assert torch.equal(grads[0], grads[1])
    if shape == "gray":
        # the view hands the gradient back in the input's own strides
        assert grads[1].stride() == x.stride()


@pytest.mark.parametrize("case", ["gray_nchw", "gray_nhwc", "rgb_nchw",
                                  "rgb_nhwc"])
def test_cpu_inputs_pass_through_and_are_not_counted(case):
    shape, layout = case.split("_")
    x = (_nchw if layout == "nchw" else _nhwc_view)(SHAPES[shape])
    before = dict(encoder_layouts)
    assert nhwc_input(x) is x
    assert nhwc_input(x, cuda=False) is x
    assert encoder_layouts == before


def test_the_counter_counts_each_cuda_input_by_layout():
    before = dict(encoder_layouts)
    for shape in SHAPES.values():
        nhwc_input(_nchw(shape), cuda=True)
        nhwc_input(_nhwc_view(shape), cuda=True)
        nhwc_input(_nhwc_view(shape), cuda=True)
    assert {k: v - before[k] for k, v in encoder_layouts.items()} \
        == {"nhwc": 4, "restrided": 2}


@pytest.mark.parametrize("shape", [(4, 16), (2, 3, 32), (1, 2, 3, 8, 8)])
def test_other_ranks_pass_through(shape):
    x = _nchw(shape)
    before = dict(encoder_layouts)
    assert nhwc_input(x, cuda=True) is x
    assert encoder_layouts == before


def test_buildnet_hands_a_cpu_input_to_the_encoder_as_given():
    model = BuildNet("cifarcnn", head="linear", feat_dim=16,
                     generator=torch.Generator().manual_seed(0))
    seen = []
    model.encoder.register_forward_pre_hook(
        lambda m, args: seen.append(args[0]))
    before = dict(encoder_layouts)
    for x in (_nchw(SHAPES["rgb"]), _nhwc_view(SHAPES["rgb"])):
        model(x)
        assert seen[-1] is x
    assert encoder_layouts == before


@pytest.mark.parametrize("name,shape", [("resnet18", "gray"),
                                        ("resnet18_s2d", "rgb"),
                                        ("wrn-28-2", "rgb"),
                                        ("cifarcnn", "rgb")])
def test_encoders_compute_the_same_on_nhwc_input(name, shape):
    """Every encoder gives the same features on the NHWC strides the
    helper makes as on NCHW input (float64, on the CPU)."""
    n, c, h, w = SHAPES[shape]
    model = BuildNet(name, head="mlp", feat_dim=16, in_channel=c,
                     generator=torch.Generator().manual_seed(0)).double()
    model.eval()
    x = _nchw((2, c, h, w), dtype=torch.float64)
    with torch.no_grad():
        pred, feat = model(x)
        pred_v, feat_v = model(nhwc_input(x, cuda=True))
    torch.testing.assert_close(feat_v, feat, rtol=0, atol=1e-10)
    torch.testing.assert_close(pred_v, pred, rtol=0, atol=1e-10)


# -- on the card ---------------------------------------------------------------

TRANSPOSE = re.compile(r"nchwtonhwc|nhwctonchw", re.IGNORECASE)
ENCODER_SPANS = ("gl.encode", "gl.backward")
SPAN_PREFIXES = ("gl.", "pgd.")
# the robust Fashion-MNIST cells' limit on the encoder's features
FEAT_GAP = 7e-3


def _conv_channels(op):
    """The input channels of the convolution above the host op ``op``
    (its forward or its backward), None where none is above it."""
    while op is not None:
        if op.name in ("aten::cudnn_convolution",
                       "aten::convolution_backward"):
            shape = op.input_shapes[op.name == "aten::convolution_backward"]
            return shape[1]
        op = op.cpu_parent
    return None


def _kernels_by_span(events):
    """(kernel name, innermost span open at its launch, the input channels
    of the convolution that launched it) for every device kernel of a
    trace recorded with shapes: the launch is the CUDA runtime call of the
    kernel's correlation id, and the span the one that began last among
    those open at that call, on any thread."""
    from torch.autograd import DeviceType

    spans, launches, kernels = [], {}, []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                kernels.append((e.name, e.id))
        elif e.name.startswith(SPAN_PREFIXES):
            spans.append((e.name, e.time_range.start, e.time_range.end))
        elif re.match(r"^cu(da)?[A-Z]", e.name):
            launches[e.id] = e
    out = []
    for name, cid in kernels:
        call = launches.get(cid)
        t = call.time_range.start if call is not None else None
        around = [s for s in spans if t is not None and s[1] <= t <= s[2]]
        inner = max(around, key=lambda s: (s[1], -s[2]))[0] if around \
            else None
        out.append((name, inner,
                    _conv_channels(call.cpu_parent) if call else None))
    return out


def _robust_step(dev):
    """One robust GL step of the adversarial driver at the robust
    Fashion-MNIST geometry (ResNet-18, linear head, 28x28x1, PGD 5 x 0.01
    in 0.05, Adam 0.01, tau 0) at 20 base + 200 batch rows, on normalized
    NCHW rows as the driver keeps them; returns the step, the model and
    a batch."""
    from graphlearninglayer_tpu_torch.train import adversarial_driver as ad
    from graphlearninglayer_tpu_torch.train.trainer import \
        create_train_state

    lo, hi = -0.8102, 2.0227
    gen = torch.Generator(device=dev).manual_seed(11)
    x = lo + (hi - lo) * torch.rand((220, 1, 28, 28), generator=gen,
                                    device=dev)
    y = torch.arange(220, device=dev) % 10
    cfg = ad.AdvConfig("fashionmnist", "resnet18", "resnet18", lo, hi, 0.05,
                       200, 2, 0.01, 100, adam=True, lr_gamma=0.5,
                       lr_step=10)
    model = ad.build_network("resnet18", 10, in_channel=1,
                             generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, lambda _: cfg.lr, device=dev,
                               **ad._make_tx(cfg, "gl"))
    bounds = [torch.tensor(v, device=dev) for v in (lo, hi)]
    step = ad.make_train_step("gl", "robust", cfg, 10, x[:20], y[:20], gen,
                              *bounds, dev)

    def run():
        stats: list = []
        step(state, x[20:], y[20:], stats)
        return ad.max_chol_info(stats)

    return run, model, x


@pytest.mark.cuda
def test_the_robust_step_transposes_only_around_the_one_channel_stem():
    """No cuDNN layout transpose around any convolution of the encoder's
    calls but the one-channel stem's: cuDNN runs a convolution of one
    input channel by an NCHW engine whatever its strides, and transposes
    its 64-channel result (the parent transposes around every one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    run, model, x = _robust_step("cuda")
    run()                                  # builds the kernels, warms up
    torch.cuda.synchronize()
    before = dict(encoder_layouts)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in encoder_layouts.items()}
    kernels = _kernels_by_span(prof.events())
    found = [k for k in kernels if TRANSPOSE.search(k[0])]
    print("encoder_layouts", delta, "transposes",
          sorted({(s, c) for _, s, c in found}, key=str), len(found))
    # five PGD iterates and the update, each NCHW as the driver keeps them
    assert delta == {"nhwc": 0, "restrided": 6}
    assert sum(s in ENCODER_SPANS for _, s, _ in kernels) > 0
    assert [k for k in found if k[1] in ENCODER_SPANS and k[2] != 1] == []
    assert [k for k in found if k[1] not in ENCODER_SPANS] == []

    # the features of one batch given NCHW, NHWC, and through cuDNN's
    # NCHW route (the encoder called on NCHW input directly)
    model.eval()
    with torch.no_grad():
        _, f_nchw = model(x)
        _, f_nhwc = model(x.permute(0, 2, 3, 1).contiguous()
                          .permute(0, 3, 1, 2))
        f_nchw_route = l2_normalize(model.head(model.encoder(x)))
    for f in (f_nhwc, f_nchw_route):
        gap = float(torch.linalg.vector_norm((f - f_nchw).double(),
                                             dim=1).max())
        assert gap <= FEAT_GAP

