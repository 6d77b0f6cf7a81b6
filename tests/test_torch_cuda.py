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
from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2
from graphlearninglayer_tpu_torch.ops.knn import knn_tiled
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


def _knn_features(n, d, seed):
    gen = torch.Generator().manual_seed(seed)
    centers = 2.0 * torch.randn(10, d, generator=gen)
    labels = torch.randint(0, 10, (n,), generator=gen)
    x = centers[labels] + torch.randn(n, d, generator=gen)
    return torch.nn.functional.normalize(x, dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(1500, 128, 25), (1001, 100, 25),
                                   (300, 7, 64)])
def test_knn_kernel_matches_plain_on_card(cuda_device, n, d, k):
    """K2 against its plain version: the same neighbor sets on every row
    whose k-th and (k+1)-th distances are more than 1e-5 relative apart
    (closer pairs may swap under float32 rounding), dist2 within 1e-5,
    self first; the ragged n and d are masked in the kernel."""
    x = _knn_features(n, d, seed=n).to(cuda_device)
    before = k2.fused_knn.launches
    nbr, dist2 = k2.fused_knn(x, k)
    torch.cuda.synchronize()
    assert k2.fused_knn.launches == before + 1
    assert nbr.dtype == torch.int64 and dist2.dtype == torch.float32
    assert torch.equal(nbr[:, 0], torch.arange(n, device=cuda_device))
    kk = min(k + 1, n)
    pn, pd = k2.fused_knn_plain(x, kk, 512)
    safe = torch.ones(n, dtype=torch.bool, device=cuda_device)
    if kk > k:
        safe = (pd[:, k] - pd[:, k - 1]) > 1e-5 * pd[:, k - 1]
    same = (torch.sort(nbr, 1).values
            == torch.sort(pn[:, :k], 1).values).all(1)
    assert bool(same[safe].all())
    assert (dist2 - pd[:, :k]).abs().max().item() <= 1e-5
    with pytest.raises(TypeError, match="float32"):
        k2.fused_knn(x.double(), k)
    with pytest.raises(ValueError, match="contiguous"):
        k2.fused_knn(x.T.contiguous().T, k)


@pytest.mark.cuda
def test_knn_tiled_on_card_goes_through_k2(cuda_device):
    x = _knn_features(700, 64, seed=3).to(cuda_device)
    before = k2.fused_knn.launches
    nbr, dist2 = knn_tiled(x, 50)
    assert k2.fused_knn.launches == before + 1
    assert nbr.shape == (700, 50) and dist2.dtype == torch.float32
    with pytest.raises(ValueError, match="k <= 64"):
        knn_tiled(x, 65)
    # the kernel's dtype contract holds through knn_tiled: no silent cast
    with pytest.raises(TypeError, match="float32"):
        knn_tiled(x.double(), 50)
