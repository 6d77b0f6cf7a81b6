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
from graphlearninglayer_tpu_torch.ops.kernels import ell_spmm as p3
from graphlearninglayer_tpu_torch.ops.kernels import knn_topk as k2
from graphlearninglayer_tpu_torch.ops.kernels import row_sort as p1
from graphlearninglayer_tpu_torch.ops.kernels import take_along as p2
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


# K1 and K3 at the op's shape, a ragged last tile (1499: n % 4 != 0, its
# scalar copies), one tile (300 is five, 63 is one), a single row, and
# d = 130 and 7 (d % 4 != 0: 4-byte copies of x, a ragged last slice).
AFFINITY_N = [1500, 1499, 300, 63, 1]
AFFINITY_D = [128, 130, 7]


def _affinity_features(n, d, seed):
    """Unit rows for d >= 128.  For d = 7 the rows lie on a grid of 1/8 in
    [-2, 2]^7, where every product and partial sum is exact in float32, so
    the kernel and its plain version form the same d2 in any summation
    order.  (On unit rows in 7 dimensions neighbors lie close, 4 d2 / eps^2
    amplifies the rounding of |x_i|^2 + |x_j|^2, and the float32 formula
    itself moves W by about the 1e-6 bar, whatever the summation order.)"""
    gen = torch.Generator().manual_seed(seed)
    if d < 128:
        return torch.randint(-16, 17, (n, d), generator=gen).float() / 8.0
    return torch.nn.functional.normalize(torch.randn(n, d, generator=gen),
                                         dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("d", AFFINITY_D)
@pytest.mark.parametrize("n", AFFINITY_N)
def test_kernel_matches_plain_on_card(cuda_device, n, d):
    """K1 against its plain version within the JAX kernel test's bar of
    1e-6, with W exactly symmetric and exactly 0 on the diagonal."""
    x = _affinity_features(n, d, seed=n + d)
    g = tdm.build_dense_graph(x.double(), min(25, n))
    args = [t.float().to(cuda_device) for t in (x, g.eps, g.m_raw)]
    before = k1.fused_affinity_sym.launches
    got = k1.fused_affinity_sym(*args)
    torch.cuda.synchronize()
    assert k1.fused_affinity_sym.launches == before + 1
    want = k1.fused_affinity_sym_plain(*args)
    assert (got - want).abs().max().item() <= 1e-6
    assert torch.equal(got, got.T)
    assert not bool(got.diagonal().any())
    with pytest.raises(TypeError, match="float32"):
        k1.fused_affinity_sym(*(a.double() for a in args))
    if n > 1:   # a (1, d) view is contiguous whatever its strides
        with pytest.raises(ValueError, match="contiguous"):
            k1.fused_affinity_sym(args[0].T.contiguous().T, *args[1:])


@pytest.mark.cuda
def test_k1_drops_duplicated_rows_exactly(cuda_device):
    """Rows copied onto other rows (d2 = 0) are each other's nearest
    neighbors, and K1 gives exactly 0 there: the norms and the Gram tile
    are one fmaf chain in feature order.  Elsewhere it matches the plain
    version within 1e-6 (whose norms and products round apart, so its d2
    there is not always 0)."""
    n, d = 300, 128
    x = _affinity_features(n, d, seed=11)
    src, dup = torch.arange(10, 30), torch.arange(150, 170)
    x[dup] = x[src]
    g = tdm.build_dense_graph(x.double(), 25)
    assert bool(g.m_raw[dup, src].all())
    args = [t.float().to(cuda_device) for t in (x, g.eps, g.m_raw)]
    got = k1.fused_affinity_sym(*args)
    want = k1.fused_affinity_sym_plain(*args)
    torch.cuda.synchronize()
    assert not bool(got[dup, src].any()) and not bool(got[src, dup].any())
    assert not bool(got.diagonal().any())
    keep = torch.ones((n, n), dtype=torch.bool, device=cuda_device)
    keep[dup, src] = keep[src, dup] = False
    assert (got - want)[keep].abs().max().item() <= 1e-6


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


def _integer_features(n, d, distinct, seed):
    """n rows drawn from ``distinct`` integer rows in [-2, 2]^d: every
    distance is an integer that float32 holds exactly, and the duplicated
    rows make many exact ties."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-2, 3, (distinct, d)).astype(np.float32)
    return torch.from_numpy(base[rng.integers(0, distinct, n)])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k,distinct", [
    (100, 16, 10, 40),     # below one 128-row tile
    (300, 7, 64, 60),      # d not a multiple of 4, k = 64
    (1001, 130, 1, 200),   # k = 1, ragged n, d past the resident panel
    (3000, 33, 50, 40),    # ~75 copies of each row: ties across tiles
    (129, 4, 64, 129),     # one row past a tile
    # on 132 SMs: no whole wave, blocks of 3 and of 4 rows a warp
    (5000, 8, 20, 300),
    (8000, 8, 10, 300),
    # one wave of 128-row panels, then blocks of 6 and of 7 rows a warp
    (28896, 8, 12, 300),
    (30896, 8, 16, 300),
])
def test_knn_kernel_edges_on_card(cuda_device, n, d, k, distinct):
    """K2 at the edges of its tiling and block plan, exactly: on integer
    features with duplicated rows the kernel must return the stable sort
    of the plain distance panel (self first at -1, ties to the lower
    index), indices and distances alike."""
    x = _integer_features(n, d, distinct, seed=n + d).to(cuda_device)
    before = k2.fused_knn.launches
    nbr, dist2 = k2.fused_knn(x, k)
    torch.cuda.synchronize()
    assert k2.fused_knn.launches == before + 1
    x64 = x.double()
    sq = (x64 * x64).sum(1)
    for r0 in range(0, n, 2048):
        rows = torch.arange(r0, min(r0 + 2048, n), device=cuda_device)
        d2 = (sq[rows, None] + sq[None, :]
              - 2.0 * (x64[rows] @ x64.T)).clamp_min(0.0)
        d2[rows - r0, rows] = -1.0
        want_d, want_n = torch.sort(d2, dim=1, stable=True)
        assert torch.equal(nbr[rows], want_n[:, :k])
        assert torch.equal(dist2[rows].double(),
                           want_d[:, :k].clamp_min(0.0))


@pytest.mark.cuda
def test_knn_tiled_on_card_goes_through_k2(cuda_device):
    """k <= 64 launches K2; k = 65 takes the blocked route on the card, the
    plain version's arithmetic, with no launch; K2 itself still refuses
    k > 64."""
    x = _knn_features(700, 64, seed=3).to(cuda_device)
    before = k2.fused_knn.launches
    nbr, dist2 = knn_tiled(x, 50)
    assert k2.fused_knn.launches == before + 1
    assert nbr.shape == (700, 50) and dist2.dtype == torch.float32
    nbr65, dist65 = knn_tiled(x, 65)
    assert k2.fused_knn.launches == before + 1
    want_n, want_d = k2.fused_knn_plain(x, 65)
    assert torch.equal(nbr65, want_n) and torch.equal(dist65, want_d)
    assert nbr65.shape == (700, 65) and nbr65.is_cuda
    with pytest.raises(ValueError, match="k <= 64"):
        k2.fused_knn(x, 65)
    # the kernel's dtype contract holds through knn_tiled: no silent cast
    with pytest.raises(TypeError, match="float32"):
        knn_tiled(x.double(), 50)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,epsilon",
                         [(n, d, "auto") for n in AFFINITY_N
                          for d in AFFINITY_D] + [(300, 128, 1.5)])
def test_k3_matches_plain_on_card(cuda_device, n, d, epsilon):
    """K3 with the raw KNN mask (k=25, asymmetric, no self loops, as the
    JAX kernel test's graph mask has none) against its plain version,
    within that test's bar of 1e-6: each triangle takes its own mask entry
    (exactly 0 where its entry is 0, whatever the transposed entry).  On
    the diagonal d2 is float32 cancellation and W ~ 1, so two summation
    orders differ there by more than 1e-6."""
    x = _affinity_features(n, d, seed=n + d)
    g = tdm.build_dense_graph(x.double(), min(25, n), epsilon)
    mask = g.m_raw.clone().fill_diagonal_(0.0)
    if n > 26:
        assert bool((mask != mask.T).any())
    args = [t.float().to(cuda_device) for t in (x, g.eps, mask)]
    before = k1.fused_affinity.launches
    got = k1.fused_affinity(*args)
    torch.cuda.synchronize()
    assert k1.fused_affinity.launches == before + 1
    want = k1.fused_affinity_plain(*args)
    assert (got - want).abs().max().item() <= 1e-6
    assert not bool(got[args[2] == 0].any())
    with pytest.raises(TypeError, match="float32"):
        k1.fused_affinity(*(a.double() for a in args))
    if n > 1:   # a (1, 1) mask is contiguous transposed too
        with pytest.raises(ValueError, match="contiguous"):
            k1.fused_affinity(args[0], args[1], args[2].T)


def _gapped_features(n, d, k, seed):
    """Unit features whose k-th and (k+1)-th neighbor distances differ by
    at least 1e-5 on every row, so that float32 and float64 pick the same
    graph."""
    while True:
        gen = torch.Generator().manual_seed(seed)
        x = torch.nn.functional.normalize(torch.randn(n, d, generator=gen),
                                          dim=1)
        d2 = torch.cdist(x.double(), x.double()).pow(2)
        d2.fill_diagonal_(-1.0)
        s = torch.sort(d2, dim=1).values
        if (s[:, k] - s[:, k - 1]).min().item() >= 1e-5:
            return x
        seed += 1


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["cholesky", "cg"])
def test_edge_mode_on_card_matches_cpu_float64(cuda_device, solver):
    """Edge mode forward and backward in float32 on the card against the
    port in float64 on the CPU (the bars of chip_smoke.py's op phase:
    pred 1e-4, dX 1e-3 of its largest entry), and against dense mode on
    the card."""
    from graphlearninglayer_tpu_torch.ops import laplace_learning

    n, k_lab, l, k = 600, 100, 5, 10
    x = _gapped_features(n, 32, k, 0)
    gen = torch.Generator().manual_seed(1)
    y = torch.nn.functional.one_hot(torch.randint(0, l, (k_lab,),
                                                  generator=gen), l)
    gbar = torch.randn(n - k_lab, l, generator=gen, dtype=torch.float64)

    def run(xv, yv, gv, **kw):
        xv = xv.clone().requires_grad_(True)
        stats = {}
        pred = laplace_learning(xv, yv, tau=0.07, k=k, stats=stats, **kw)
        (pred * gv).sum().backward()
        return pred.detach().double().cpu(), xv.grad.double().cpu(), stats

    want, want_gx, _ = run(x.double(), y.double(), gbar, mode="edge",
                           solver=solver)
    args = (x.to(cuda_device), y.float().to(cuda_device),
            gbar.float().to(cuda_device))
    pred, gx, stats = run(*args, mode="edge", solver=solver)
    scale = want_gx.abs().max()
    assert (pred - want).abs().max().item() <= 1e-4
    assert ((gx - want_gx).abs().max() / scale).item() <= 1e-3
    if solver == "cg":
        assert stats["cg_iters"] > 0 and stats["cg_iters_bwd"] > 0
    dense, dense_gx, _ = run(*args, mode="dense")
    assert (pred - dense).abs().max().item() <= 1e-4
    assert ((gx - dense_gx).abs().max() / scale).item() <= 1e-3


def _robust_gl_inputs(device):
    """The cifar10 config's robust GL step at 300 nodes: a seeded
    PreActResNet-18's train state, 100 base + 200 batch random images and
    their labels, the data range and the config."""
    from graphlearninglayer_tpu_torch.train import adversarial_driver as ad

    cfg = ad.DATASET_CONFIGS["cifar10"]
    gen = torch.Generator().manual_seed(0)
    base = torch.rand(100, 3, 32, 32, generator=gen).to(device) * 3 - 1.5
    x = torch.rand(200, 3, 32, 32, generator=gen).to(device) * 3 - 1.5
    base_y = torch.arange(10).repeat(10).to(device)
    y = torch.randint(0, 10, (200,), generator=gen).to(device)
    lo, hi = (torch.tensor(v, device=device) for v in (cfg.min_val,
                                                        cfg.max_val))
    model = ad.build_network("preactresnet18", 10, 3,
                             torch.Generator().manual_seed(0))
    state = create_train_state(model, ad._make_schedule(cfg, 20),
                               device=device, **ad._make_tx(cfg, "gl"))
    return state, base, base_y, x, y, lo, hi, cfg


def _robust_gl_step(device, adv=None):
    """One robust GL step of the cifar10 config on the card (5 PGD
    iterations and one SGD step; tau = 0, k = 25); with ``adv``, the SGD
    step alone on those adversarial images.  Returns the loss, the
    adversarial images, K1's launches in the step and every op call's
    Cholesky info."""
    from graphlearninglayer_tpu_torch.attack.pgd import make_gl_pgd_perturb_p
    from graphlearninglayer_tpu_torch.train import adversarial_driver as ad

    state, base, base_y, x, y, lo, hi, cfg = _robust_gl_inputs(device)
    stats = []
    before = k1.fused_affinity_sym.launches
    if adv is None:
        perturb = make_gl_pgd_perturb_p(
            ad._eval_features, 10, tau=0.0, k=25, eps=cfg.pgd_epsilon,
            alpha=cfg.pgd_alpha, num_iters=cfg.pgd_iters, device=device)
        adv = perturb(state.model, base, base_y, x, y,
                      torch.Generator(device=device).manual_seed(0), lo, hi,
                      stats)
    loss, op_stats = ad._gl_train_step(state, 10, dict(tau=0.0, k=25),
                                       base, base_y, adv, y)
    launches = k1.fused_affinity_sym.launches - before
    infos = [int(s["chol_info"]) for s in stats + [op_stats]]
    return loss.item(), adv, launches, infos


@pytest.mark.cuda
def test_robust_gl_step_on_card_launches_k1_six_times(cuda_device,
                                                     monkeypatch):
    """Five PGD op calls and the training step's: K1 six times, every
    Cholesky at tau = 0 succeeding.  Then the training step on the same
    adversarial images with K1's plain version in its place (no launch):
    the loss within 1e-4 relative.  The PGD calls are held against the
    plain version by ``test_robust_gl_pgd_gradients_k1_against_plain``.
    TF32 is off for the convolutions, as for the matrix products."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    loss, adv, launches, infos = _robust_gl_step(cuda_device)
    assert launches == 6
    assert infos == [0] * 6 and np.isfinite(loss)
    monkeypatch.setattr(tdm, "fused_affinity_sym",
                        k1.fused_affinity_sym_plain)
    plain_loss, _, plain_launches, plain_infos = _robust_gl_step(
        cuda_device, adv)
    assert plain_launches == 0 and plain_infos == [0]
    assert abs(loss - plain_loss) <= 1e-4 * abs(plain_loss)


# PGD against the plain affinity: the input gradient's largest error
# relative to its largest entry, and the share of pixels whose first PGD
# step may differ
PGD_GRAD_TOL = 1e-3
PGD_MAX_FLIPS = 1e-3


@pytest.mark.cuda
def test_robust_gl_pgd_gradients_k1_against_plain(cuda_device, monkeypatch):
    """The robust step's five PGD op calls, K1 against its plain version,
    with deterministic algorithms and TF32 off.

    Along K1's PGD run, each iteration's input gradient (before the sign)
    is taken at the same images with K1 and with the plain affinity: they
    agree within ``PGD_GRAD_TOL`` of the largest entry, so their signs can
    differ only where the gradient lies inside that error band.  K1's walk
    equals ``pgd_iterations`` bit for bit.  A PGD run with each affinity
    from the same start: their first steps differ only on pixels whose
    gradient signs differ (at most ``PGD_MAX_FLIPS`` of the pixels).  The
    later iterations spread those few flipped pixels over the images; a run
    with K1 throughout, started from the plain run's first step, spreads
    them as far, so the spread is PGD's own sensitivity, not the
    affinity's."""
    from graphlearninglayer_tpu_torch.attack.fgsm import gl_loss, input_grad
    from graphlearninglayer_tpu_torch.attack.pgd import (pgd_iterations,
                                                         uniform_start)
    from graphlearninglayer_tpu_torch.train import adversarial_driver as ad

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        state, base, base_y, x, y, lo, hi, cfg = _robust_gl_inputs(
            cuda_device)
        stats = []
        loss = gl_loss(lambda imgs: ad._eval_features(state.model, imgs),
                       10, dict(tau=0.0, k=25), base, base_y, y, stats)
        start = uniform_start(x, cfg.pgd_epsilon, torch.Generator(
            device=cuda_device).manual_seed(0), lo, hi)

        def plain_grad(data):
            with monkeypatch.context() as m:
                m.setattr(tdm, "fused_affinity_sym",
                          k1.fused_affinity_sym_plain)
                return input_grad(loss, data)

        def step(data, g):
            data = torch.clamp(data + cfg.pgd_alpha * torch.sign(g),
                               x - cfg.pgd_epsilon, x + cfg.pgd_epsilon)
            return torch.clamp(data, lo, hi)

        def walk(data, grad, iters):
            for _ in range(iters):
                data = step(data, grad(data))
            return data

        walk_k1, rel_errs, flips = [start], [], []
        for _ in range(cfg.pgd_iters):
            g = input_grad(loss, walk_k1[-1])
            gp = plain_grad(walk_k1[-1])
            rel_errs.append(((g - gp).abs().max() / gp.abs().max()).item())
            flips.append(torch.sign(g) != torch.sign(gp))
            walk_k1.append(step(walk_k1[-1], g))
        adv = pgd_iterations(loss, start, x, cfg.pgd_alpha, cfg.pgd_epsilon,
                             cfg.pgd_iters, lo, hi)
        first_plain = step(start, plain_grad(start))
        adv_plain = walk(first_plain, plain_grad, cfg.pgd_iters - 1)
        adv_seeded = walk(first_plain, lambda d: input_grad(loss, d),
                          cfg.pgd_iters - 1)
        first_differ = walk_k1[1] != first_plain
        apart = int((adv != adv_plain).sum())
        seeded_apart = int((adv_seeded != adv).sum())
        print(f"PGD K1 against plain: gradient error / largest {rel_errs}, "
              f"sign flips {[int(f.sum()) for f in flips]}; first steps "
              f"differ on {int(first_differ.sum())} pixels; final images "
              f"differ on {apart} of {adv.numel()} pixels; K1 from plain's "
              f"first step ends {seeded_apart} pixels from K1's run")
        assert all(e <= PGD_GRAD_TOL for e in rel_errs)
        assert all(int(s["chol_info"]) == 0 for s in stats)
        assert torch.equal(adv, walk_k1[-1])
        assert torch.all(flips[0][first_differ])
        assert first_differ.sum() <= PGD_MAX_FLIPS * adv.numel()
        assert seeded_apart >= apart // 2
    finally:
        torch.use_deterministic_algorithms(False)


# ---------------------------------------------------------------------------
# the device-resident data path and the compare driver's step


def _aug_images(seed):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (32, 32, 3), np.uint8)
    rgb[..., 1] = 40 + (rgb[..., 1] % 150)      # a limited-range channel
    return [rgb, rng.integers(0, 256, (28, 28, 1), np.uint8)]


@pytest.mark.cuda
def test_device_aug_ops_on_card_equal_cpu(cuda_device):
    """Every RandAugment op at four magnitudes and both signs, the prefix
    warp and the cutout: the card's uint8 output equals the CPU's (float64
    coordinates on both)."""
    from graphlearninglayer_tpu_torch.data import device_aug as da

    for img in _aug_images(1):
        on_card = torch.from_numpy(img).to(cuda_device)
        for op in range(14):
            lo, hi = float(da._OP_LO[op]), float(da._OP_HI[op])
            for frac in (0.0, 0.33, 0.77, 1.0):
                for sign in (False, True):
                    v = lo + frac * (hi - lo)
                    got = da.device_apply_op(on_card, op, v, sign)
                    assert got.is_cuda
                    want = da.device_apply_op(img, op, v, sign)
                    assert torch.equal(got.cpu(), want), (op, v, sign)
        for mode in ("weak", "strong"):
            name = "cifar10" if img.shape[-1] == 3 else "mnist"
            tf = da.DeviceTransform(name, mode)
            batch = torch.from_numpy(np.stack([img] * 16)).to(cuda_device)
            params = tf.draw(16, torch.Generator(device=cuda_device).manual_seed(0),
                             cuda_device)
            got = tf.apply(batch, params)
            cpu = {k: v.cpu() for k, v in params.items()
                   if isinstance(v, torch.Tensor)}
            cpu["rounds"] = [tuple(t.cpu() for t in r)
                             for r in params["rounds"]]
            cpu["cutout"] = tuple(t.cpu() for t in params["cutout"])
            assert torch.equal(got.cpu(), tf.apply(batch.cpu(), cpu))
            assert len({o.cpu().numpy().tobytes() for o in got}) > 1


def _tiny_state(device, seed=0, num_classes=4):
    model = BuildNet("resnet18", num_classes=num_classes,
                     generator=torch.Generator().manual_seed(seed))
    return create_train_state(model, make_lr_schedule(0.01, 1, 1),
                              device=device)


@pytest.mark.cuda
def test_from_data_gl_step_on_card_launches_k1_once(cuda_device):
    """The resident-data GL step gathers and augments its rows on the card
    and launches K1 once; only index and label vectors come from the
    host."""
    from graphlearninglayer_tpu_torch.data import DeviceTransform
    from graphlearninglayer_tpu_torch.train import (
        make_gl_train_step_from_data)

    rng = np.random.default_rng(2)
    data = torch.from_numpy(rng.integers(0, 256, (64, 16 * 16 * 3),
                                         dtype=np.uint8)).to(cuda_device)
    labels = rng.integers(0, 4, 64)
    step = make_gl_train_step_from_data(
        4, (16, 16, 3), tau=0.07, k=5, norm=CHANNEL_STATS["cifar10"],
        aug=DeviceTransform("cifar10", "strong"),
        generator=torch.Generator(device=cuda_device).manual_seed(0))
    state = _tiny_state(cuda_device)
    base, idx = np.arange(12), np.arange(12, 48)
    before = k1.fused_affinity_sym.launches
    state, metrics, scores = step(state, data, base, labels[base], idx,
                                  labels[idx])
    assert k1.fused_affinity_sym.launches == before + 1
    host = metrics_to_host(metrics)
    assert np.isfinite(host["loss"]) and host["chol_info"] == 0
    assert scores.is_cuda and scores.shape == (36,)


@pytest.mark.cuda
def test_resident_encode_on_card_equals_streaming(cuda_device):
    """On the card the resident encode (tail re-sliced) gives the
    streaming encode's features bit for bit (TF32 off)."""
    from graphlearninglayer_tpu_torch.evalx import (encode_dataset,
                                                    encode_dataset_resident)
    from graphlearninglayer_tpu_torch.train import make_encode_step

    torch.backends.cudnn.allow_tf32 = False
    try:
        images = np.random.default_rng(3).integers(
            0, 256, (300, 32, 32, 3), dtype=np.uint8)
        state = _tiny_state(cuda_device)
        norm = CHANNEL_STATS["cifar10"]
        stream = encode_dataset(make_encode_step(norm=norm), state, images,
                                batch_size=128)
        data = torch.from_numpy(images.reshape(300, -1)).to(cuda_device)
        res = encode_dataset_resident(state, data, 300, (32, 32, 3), norm,
                                      batch_size=128)
        assert res.is_cuda and res.shape == (300, 128)
        assert torch.equal(res, stream)
    finally:
        torch.backends.cudnn.allow_tf32 = True


@pytest.mark.cuda
def test_compare_step_on_card_launches_k1_once(cuda_device):
    """The compare driver's step evaluates the GL loss on the card through
    K1 (once) before the MLP head's update."""
    from graphlearninglayer_tpu_torch.data import normalize_batch
    from graphlearninglayer_tpu_torch.train.compare_to_mlp import \
        make_compare_step

    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (48, 16, 16, 3)).astype(np.uint8)
    labels = rng.integers(0, 4, 48)
    norm = CHANNEL_STATS["cifar10"]
    step = make_compare_step(4, normalize_batch(images[:12], *norm),
                             labels[:12], tau=0.07, k=5, norm=norm)
    state = _tiny_state(cuda_device)
    before = k1.fused_affinity_sym.launches
    state, mlp_loss, gl_loss = step(state, images[12:], labels[12:])
    assert k1.fused_affinity_sym.launches == before + 1
    assert mlp_loss.is_cuda and gl_loss.is_cuda
    assert np.isfinite(mlp_loss.item()) and np.isfinite(gl_loss.item())
    assert state.step == 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(1500, 128, 25), (1001, 100, 25),
                                   (3000, 33, 50)])
def test_knn_row_ranges_on_card_equal_the_full_call(cuda_device, n, d, k):
    """K2 over a row range returns the full call's rows bit for bit (halves,
    ragged ends, a range starting off a multiple of 4, a single row), with
    self at its global index; against the plain version's range as in
    test_knn_kernel_matches_plain_on_card; a bad range raises."""
    x = _knn_features(n, d, seed=n + 1).to(cuda_device)
    nbr, dist2 = k2.fused_knn(x, k)
    for r0, r1 in ((0, n // 2), (n // 2, n), (3, n - 5), (n - 1, n),
                   (777, 1000)):
        before = k2.fused_knn.launches
        got_n, got_d = k2.fused_knn(x, k, rows=(r0, r1))
        torch.cuda.synchronize()
        assert k2.fused_knn.launches == before + 1
        assert got_n.shape == (r1 - r0, k)
        assert torch.equal(got_n, nbr[r0:r1])
        assert torch.equal(got_d, dist2[r0:r1])
        pn, pd = k2.fused_knn_plain(x, k + 1, 512, rows=(r0, r1))
        safe = (pd[:, k] - pd[:, k - 1]) > 1e-5 * pd[:, k - 1]
        same = (torch.sort(got_n, 1).values
                == torch.sort(pn[:, :k], 1).values).all(1)
        assert bool(same[safe].all())
        assert (got_d - pd[:, :k]).abs().max().item() <= 1e-5
    for bad in ((5, 5), (-1, 3), (0, n + 1)):
        with pytest.raises(ValueError, match="rows"):
            k2.fused_knn(x, k, rows=bad)


@pytest.fixture
def nccl_world_of_one(cuda_device, tmp_path):
    """This process as a process group of one rank over NCCL."""
    import torch.distributed as dist

    from graphlearninglayer_tpu_torch.parallel import (global_mesh,
                                                       initialize_multihost)

    assert initialize_multihost(f"file://{tmp_path}/store", 1, 0, 0, "cuda")
    try:
        assert dist.get_backend() == "nccl"
        yield global_mesh(("data", "graph"))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_cross_rank_batchnorm_and_sharded_gl_step_on_card(nccl_world_of_one):
    """In a world of one over NCCL the cross-rank BatchNorm is
    nn.BatchNorm2d (output, input gradient and running statistics equal),
    and the sharded GL step is the unsharded step (two steps of ResNet-18
    at 40 + 160 images, TF32 off, each from the same state: loss within
    1e-5 relative, scores within 1e-4), with K1 once a step.  (Run free,
    two trajectories may part after a step: the op's backward sums with
    atomics on the card.)  The two-pass statistics across ranks are
    held against the unsharded step on gloo CPU ranks
    (tests/test_torch_sharded_train.py) and by chip_smoke.py's two ranks
    sharing the card."""
    from graphlearninglayer_tpu_torch.parallel import (
        CrossRankBatchNorm2d, convert_cross_rank_bn)
    from graphlearninglayer_tpu_torch.train import make_sharded_gl_train_step

    mesh = nccl_world_of_one
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(16, 8, 5, 5, generator=gen) * 3 + 1).cuda()
    bn = torch.nn.BatchNorm2d(8).cuda()
    cross = convert_cross_rank_bn(torch.nn.Sequential(
        torch.nn.BatchNorm2d(8)).cuda(), mesh)[0]
    assert isinstance(cross, CrossRankBatchNorm2d)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    ya, yb = bn(xa), cross(xb)
    (ya * ya.detach()).sum().backward()
    (yb * yb.detach()).sum().backward()
    assert torch.equal(ya, yb) and torch.equal(xa.grad, xb.grad)
    for name in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(bn, name), getattr(cross, name))

    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (400, 32, 32, 3)).astype(np.uint8)
    labels = rng.integers(0, 10, 400)

    def state():
        model = BuildNet("resnet18", num_classes=10,
                         generator=torch.Generator().manual_seed(0))
        return create_train_state(model, make_lr_schedule(0.01, 1, 2))

    norm = CHANNEL_STATS["cifar10"]
    plain = make_gl_train_step(10, tau=0.07, k=25, norm=norm)
    sharded = make_sharded_gl_train_step(10, mesh, tau=0.07, k=25,
                                         norm=norm)
    sa, sb = state(), state()
    for s in range(2):
        b, t = slice(200 * s, 200 * s + 40), slice(200 * s + 40, 200 * s + 200)
        args = (images[b], labels[b], images[t], labels[t])
        sa.model.load_state_dict(sb.model.state_dict())
        sa, ma, sca = plain(sa, *args)
        before = k1.fused_affinity_sym.launches
        sb, mb, scb = sharded(sb, *args)
        assert k1.fused_affinity_sym.launches == before + 1
        la, lb = metrics_to_host(ma)["loss"], metrics_to_host(mb)["loss"]
        assert abs(la - lb) <= 1e-5 * abs(la), (s, la, lb)
        assert (sca - scb).abs().max().item() <= 1e-4
    torch.backends.cudnn.allow_tf32 = True


@pytest.mark.cuda
def test_edge_sharded_eval_on_card_launches_k2_once(nccl_world_of_one,
                                                    monkeypatch):
    """The edge-sharded eval in a world of one: one K2 launch a build, over
    the rank's rows; the single-device solve's classes on 99.9% of rows;
    the cached second eval reuses the permutation."""
    from graphlearninglayer_tpu_torch.ops import (EvalGraphCache,
                                                  one_hot_encode,
                                                  transductive_laplace)
    from graphlearninglayer_tpu_torch.parallel import (
        edge_sharded_transductive_laplace, global_mesh)

    mesh = global_mesh(("graph",))
    x = _knn_features(5003, 64, seed=7).cuda()
    y = one_hot_encode(torch.arange(60) % 10, 10).cuda()
    rows = []
    launch = k2._launch
    monkeypatch.setattr(k2, "_launch", lambda x, k, r0, r1: rows.append(
        (r0, r1)) or launch(x, k, r0, r1))
    cache = EvalGraphCache()
    before = k2.fused_knn.launches
    pred, iters, err = edge_sharded_transductive_laplace(
        mesh, x, y, knn_num=50, return_info=True, cache=cache)
    assert k2.fused_knn.launches == before + 1 and rows == [(0, 5003)]
    assert err <= 1e-10 and cache.shard_nd == 1
    want = transductive_laplace(x, y, knn_num=50)
    agree = (pred.argmax(1) == want.argmax(1)).float().mean().item()
    assert agree >= 0.999
    perm = cache.shard_perm
    edge_sharded_transductive_laplace(mesh, x, y, knn_num=50, cache=cache)
    assert cache.shard_perm is perm and k2.fused_knn.launches == before + 3


@pytest.mark.cuda
def test_entry_on_card_launches_k1_once(cuda_device):
    """entry() at the flagship shape (ResNet-18, 250 + 1250 nodes, k=25):
    K1 once a forward, finite (1250, 10) scores."""
    from graphlearninglayer_tpu_torch.entry import entry

    forward, args = entry()
    assert args[1].device.type == "cuda"
    before = k1.fused_affinity_sym.launches
    scores = forward(*args)
    torch.cuda.synchronize()
    assert k1.fused_affinity_sym.launches == before + 1
    assert scores.shape == (1250, 10)
    assert bool(torch.isfinite(scores).all())


@pytest.mark.cuda
def test_sharded_attack_world_of_one_equals_single_device(nccl_world_of_one):
    """The sharded FGSM and IFGSM in a world of one over NCCL give the
    single-device attack's images and predictions exactly (TF32 off, cuDNN
    and PyTorch deterministic: the dense op's backward sums with index_add,
    atomics on the card otherwise), K1 iters + 1 times a point, every
    Cholesky factored.  The dry run's attack network, 100 base + 60 batch
    32x32x3 images, tau 0, k 25."""
    from graphlearninglayer_tpu_torch.attack import (
        make_gl_fast_gradient_attack, make_sharded_gl_fast_gradient_attack)
    from graphlearninglayer_tpu_torch.attack.fgsm import max_chol_info
    from graphlearninglayer_tpu_torch.entry import SmallEncoder
    from graphlearninglayer_tpu_torch.models import init_weights

    model = SmallEncoder(10, in_channel=3)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.cuda().eval()

    def encode(x):
        return model(x)[1]

    gen = torch.Generator().manual_seed(1)
    base = torch.randn(100, 3, 32, 32, generator=gen).cuda()
    images = torch.randn(60, 3, 32, 32, generator=gen).cuda()
    base_labels = (torch.arange(100) % 10).cuda()
    labels = torch.randint(0, 10, (60,), generator=gen).cuda()
    single = make_gl_fast_gradient_attack(encode, 10, k=25)
    sharded = make_sharded_gl_fast_gradient_attack(encode, 10,
                                                   nccl_world_of_one, k=25)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for kind, eps, iters in (("fgsm", 0.1, 1), ("ifgsm", 0.1, 10)):
            args = (base, base_labels, images, labels, eps, kind, -3.0, 3.0)
            stats_a, stats_b = [], []
            want, want_pred = single(*args, stats_a)
            before = k1.fused_affinity_sym.launches
            got, got_pred = sharded(*args, stats_b)
            torch.cuda.synchronize()
            assert k1.fused_affinity_sym.launches == before + iters + 1
            assert max_chol_info(stats_a) == max_chol_info(stats_b) == 0
            assert torch.equal(got, want) and torch.equal(got_pred, want_pred)
            assert (got - images).abs().max().item() > 0.09
    finally:
        torch.use_deterministic_algorithms(False)
        torch.backends.cudnn.deterministic = False
        torch.backends.cudnn.allow_tf32 = True


def _ell(m, n, s, padding, seed):
    """A random ELL structure of m rows over n columns with s slots, on
    the card: positive values, and with ``padding`` the trailing slots of
    each row (a random count) padding (column 0, value 0), as
    ``build_sym_ell`` pads; with ``padding="scattered"`` four in five
    slots anywhere in the row (a masked edge's slot is 0 too)."""
    gen = torch.Generator().manual_seed(seed)
    nbr = torch.randint(0, n, (m, s), generator=gen)
    val = torch.rand((m, s), generator=gen)
    if padding == "scattered":
        pad = torch.rand((m, s), generator=gen) < 0.8
        nbr, val = nbr.masked_fill(pad, 0), val.masked_fill(pad, 0.0)
    elif padding:
        used = torch.randint(0, s + 1, (m, 1), generator=gen)
        pad = torch.arange(s)[None, :] >= used
        nbr, val = nbr.masked_fill(pad, 0), val.masked_fill(pad, 0.0)
    return nbr.cuda(), val.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("padding", [False, True, "scattered"])
@pytest.mark.parametrize("l", [3, 10, 100, 130])
@pytest.mark.parametrize("n", [1000, 20000])
def test_ell_gather_spmm_matches_plain_on_card(cuda_device, n, l, padding):
    """P3 against its plain version: within 1e-6 max_i sum_s |val[i, s]|
    max |x| an entry (the kernel sums the slots in another order than
    torch.sum); with padding slots, the rows of a half of x's (a rank's
    rows of the row-sharded solve) indexing all of it.  l = 3, 10 and 100
    take the kernel's three lane layouts, 130 two passes over the slots."""
    m = n // 2 if padding else n
    nbr, val = _ell(m, n, 96, padding, seed=n + l)
    x = torch.randn((n, l), generator=torch.Generator().manual_seed(l)
                    ).cuda()
    before = p3.ell_gather_spmm.launches
    got = p3.ell_gather_spmm(nbr, val, x)
    torch.cuda.synchronize()
    assert p3.ell_gather_spmm.launches == before + 1
    assert got.shape == (m, l) and got.dtype == torch.float32
    want = p3.ell_gather_spmm_plain(nbr, val, x)
    bar = 1e-6 * val.abs().sum(1).max().item() * x.abs().max().item()
    assert (got - want).abs().max().item() <= bar


@pytest.mark.cuda
def test_ell_gather_spmm_raises_on_what_it_does_not_take(cuda_device):
    nbr, val = _ell(50, 80, 8, False, seed=0)
    x = torch.randn((80, 10), device="cuda")
    with pytest.raises(TypeError, match="int64"):
        p3.ell_gather_spmm(nbr.int(), val, x)
    with pytest.raises(TypeError, match="float32"):
        p3.ell_gather_spmm(nbr, val.double(), x)
    with pytest.raises(TypeError, match="float32"):
        p3.ell_gather_spmm(nbr, val, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        p3.ell_gather_spmm(nbr, val, x.T.contiguous().T)
    with pytest.raises(ValueError, match="contiguous"):
        p3.ell_gather_spmm(nbr.T.contiguous().T, val, x)


@pytest.mark.cuda
def test_ell_solve_on_card_launches_p3_each_matvec(cuda_device):
    """transductive_laplace(mode='ell') on the card: P3 once a matvec,
    iterations + 2 launches a solve (the right-hand side, the start
    residual, one a CG step), converged, and the 'sorted' solve's classes
    on 99.9% of the rows."""
    from graphlearninglayer_tpu_torch.ops import (one_hot_encode,
                                                  transductive_laplace)

    x = _knn_features(5003, 64, seed=3).cuda()
    y = one_hot_encode(torch.arange(60) % 10, 10).cuda()
    before = p3.ell_gather_spmm.launches
    pred, iters, err = transductive_laplace(x, y, knn_num=50, mode="ell",
                                            return_info=True)
    assert p3.ell_gather_spmm.launches - before == iters + 2
    assert err <= 1e-10 and bool(torch.isfinite(pred).all())
    want = transductive_laplace(x, y, knn_num=50, mode="sorted")
    agree = (pred.argmax(1) == want.argmax(1)).float().mean().item()
    assert agree >= 0.999


@pytest.mark.cuda
def test_ell_solve_on_card_raises_on_float64(cuda_device):
    """P3 takes float32 only, so a float64 ELL solve on the card (k > 64:
    the plain KNN route, which takes float64, where K2 would raise first)
    raises where its first matvec reaches the kernel; nothing falls
    back."""
    from graphlearninglayer_tpu_torch.ops import (one_hot_encode,
                                                  transductive_laplace)

    x = _knn_features(1003, 16, seed=4).double().cuda()
    y = one_hot_encode(torch.arange(30) % 10, 10).double().cuda()
    before = p3.ell_gather_spmm.launches
    with pytest.raises(TypeError, match="P3 kernel takes float32"):
        transductive_laplace(x, y, knn_num=70, mode="ell")
    assert p3.ell_gather_spmm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("q,m,ties", [(256, 512, False), (64, 1024, False),
                                      (16, 1024, True), (3, 2, True)])
def test_row_sort_equals_plain_on_card(cuda_device, q, m, ties, descending):
    """P1's bitonic sort equal to torch.sort(stable=True), values and
    indices, at the probe's 256 x 512 and at 64 x 1,024; on rows full of
    ties and NaNs the index breaks each tie as the stable sort does."""
    gen = torch.Generator().manual_seed(q + m)
    if ties:
        x = torch.randint(-3, 4, (q, m), generator=gen).float()
        x[torch.rand((q, m), generator=gen) < 0.05] = float("nan")
    else:
        x = torch.randn((q, m), generator=gen)
    x = x.cuda()
    before = p1.row_sort.launches
    vals, idx = p1.row_sort(x, descending)
    torch.cuda.synchronize()
    assert p1.row_sort.launches == before + 1
    want_v, want_i = p1.row_sort_plain(x, descending)
    assert torch.equal(idx, want_i)
    assert torch.equal(vals.nan_to_num(7.0), want_v.nan_to_num(7.0))
    with pytest.raises(TypeError, match="float32"):
        p1.row_sort(x.double())


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_scale_if_max_positive_equals_plain_on_card(cuda_device, sign):
    x = sign * torch.randn((256, 512)).abs().cuda()
    before = p1.scale_if_max_positive.launches
    got = p1.scale_if_max_positive(x)
    torch.cuda.synchronize()
    assert p1.scale_if_max_positive.launches == before + 1
    assert torch.equal(got, p1.scale_if_max_positive_plain(x))
    x[3, 4] = float("nan")      # the max is NaN: x stays
    assert torch.equal(p1.scale_if_max_positive(x).nan_to_num(7.0),
                       x.nan_to_num(7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,axis", [
    (256, 128, 0), (8192, 128, 0), (128, 128, 1), (128, 1024, 1),
    (8, 8192, 1), (65536, 128, 0)])
def test_take_along_equals_plain_on_card(cuda_device, m, n, axis):
    """P2 at the probe's six shapes, equal to torch.gather."""
    gen = torch.Generator().manual_seed(m + n)
    x = torch.randn((m, n), generator=gen).cuda()
    idx = torch.randint(0, m if axis == 0 else n, (m, n),
                        generator=gen).cuda()
    before = p2.take_along.launches
    got = p2.take_along(x, idx, axis)
    torch.cuda.synchronize()
    assert p2.take_along.launches == before + 1
    assert torch.equal(got, p2.take_along_plain(x, idx, axis))
    with pytest.raises(TypeError, match="int64"):
        p2.take_along(x, idx.int(), axis)
    with pytest.raises(TypeError, match="float32"):
        p2.take_along(x.double(), idx, axis)
