"""The yardstick's counts against hand counts and the port's model."""
import pytest
import torch

from portbench.common import counts
from portbench.encoders import resnet18


def test_kernel_bounds_match_the_kernel_table():
    ms, which = counts.k1_bound_ms(1500, 128)
    assert which == "bytes" and ms == pytest.approx(0.0056, abs=5e-5)
    ms, which = counts.k2_bound_ms(60250, 128, 50)
    assert which == "operations" and ms == pytest.approx(6.94, abs=5e-3)


@pytest.mark.parametrize("shape, head", [((32, 32, 3), "mlp"),
                                         ((28, 28, 1), "linear")])
def test_forward_macs_match_hooks_on_the_port_model(shape, head):
    from graphlearninglayer_tpu_torch.models import BuildNet

    h, w, c = shape
    model = BuildNet("resnet18", head=head, feat_dim=128, num_classes=10,
                     in_channel=c).eval()
    macs = []

    def hook(mod, args, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.weight[0].numel()
            macs.append(out[0].numel() * k)
        elif isinstance(mod, torch.nn.Linear):
            macs.append(mod.in_features * mod.out_features)

    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(2, c, h, w))
    cfg = {"image_shape": [h, w, c], "head": head, "feat_dim": 128,
           "num_classes": 10}
    assert sum(macs) == counts.forward_macs(resnet18.layers(cfg))


def test_step_counts_by_hand():
    layers = resnet18.layers({"image_shape": [32, 32, 3], "head": "mlp",
                              "feat_dim": 128, "num_classes": 10})
    fwd = counts.forward_macs(layers)
    stem = 9 * 3 * 64 * 32 * 32
    assert fwd == pytest.approx(556e6, rel=0.01)
    assert counts.train_step_flops(1500, layers) == 2 * 1500 * (3 * fwd
                                                                - stem)
    assert counts.input_grad_flops(10, layers) == 2 * 10 * 2 * fwd
