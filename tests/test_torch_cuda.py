"""Tests of the PyTorch port that need a CUDA card; they skip elsewhere.

This file imports neither JAX nor the JAX package, so it also runs on a
machine without JAX.  There, skip the shared conftest (which imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu_torch.data import CHANNEL_STATS
from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.ops import dense_mode as tdm
from graphlearninglayer_tpu_torch.ops.kernels import affinity as k1
from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                make_gl_train_step,
                                                make_lr_schedule,
                                                metrics_to_host)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1500, 300])
def test_kernel_matches_plain_on_card(cuda_device, n):
    """K1 against its plain version at the op's width, within the JAX
    kernel test's bar of 1e-6."""
    gen = torch.Generator().manual_seed(n)
    x = torch.nn.functional.normalize(torch.randn(n, 128, generator=gen),
                                      dim=1)
    g = tdm.build_dense_graph(x.double(), 25)
    args = [t.float().to(cuda_device) for t in (x, g.eps, g.m_raw)]
    before = k1.fused_affinity_sym.launches
    got = k1.fused_affinity_sym(*args)
    torch.cuda.synchronize()
    assert k1.fused_affinity_sym.launches == before + 1
    want = k1.fused_affinity_sym_plain(*args)
    assert (got - want).abs().max().item() <= 1e-6
    with pytest.raises(TypeError, match="float32"):
        k1.fused_affinity_sym(*(a.double() for a in args))
    with pytest.raises(ValueError, match="contiguous"):
        k1.fused_affinity_sym(args[0].T.contiguous().T, *args[1:])


@pytest.mark.cuda
def test_train_step_runs_on_card_through_k1(cuda_device):
    """The entry points default to the card; one small GL step launches K1
    exactly once and returns device metrics."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (48, 16, 16, 3)).astype(np.uint8)
    labels = rng.integers(0, 4, 48)
    model = BuildNet("resnet18", num_classes=4,
                     generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, make_lr_schedule(0.01, 1, 1))
    step = make_gl_train_step(4, tau=0.07, k=5, norm=CHANNEL_STATS["cifar10"])
    before = k1.fused_affinity_sym.launches
    state, metrics, scores = step(state, images[:12], labels[:12],
                                  images[12:], labels[12:])
    assert k1.fused_affinity_sym.launches == before + 1
    assert all(v.is_cuda for v in metrics.values()) and scores.is_cuda
    host = metrics_to_host(metrics)
    assert np.isfinite(host["loss"]) and host["params_finite"]
    assert host["chol_info"] == 0
