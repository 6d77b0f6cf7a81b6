"""The port's device-resident data path on the CPU: the ``*_from_data``
train steps, the resident encode and eval, and ``fullysup --device_data``.

A tiny encoder (tests/torch_tiny.py) is patched into both packages'
registries.  With the eval transform, the port's from-data GL and MLP steps
must agree with the JAX package's from identical weights in float64: loss,
scores and updated parameters within 1e-8 relative; and with the port's
host-batch steps fed the same rows bit for bit.  The resident encode must
equal the streaming encode bit for bit, and the resident transductive eval
must solve on the same features as the streaming one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.models import BuildNet as JBuildNet
from graphlearninglayer_tpu.models import buildnet as jbn
from graphlearninglayer_tpu.train import optim as joptim
from graphlearninglayer_tpu.train import trainer as jtrainer
from graphlearninglayer_tpu_torch.config.cli import parse_option
from graphlearninglayer_tpu_torch.data import CHANNEL_STATS, normalize_batch
from graphlearninglayer_tpu_torch.data import pipeline
from graphlearninglayer_tpu_torch.evalx import harness
from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.train import (
    create_train_state, fullysup, make_encode_step, make_gl_train_step,
    make_gl_train_step_from_data, make_lr_schedule, make_mlp_train_step,
    make_mlp_train_step_from_data)
from tests import torch_tiny


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU ops are tiny: one thread runs them faster, and the suite's
    parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


L, K, TAU, SHAPE = 4, 5, 0.07, (8, 8, 3)
SCHEDULE = dict(learning_rate=0.05, epochs=5, steps_per_epoch=10)
NORM = CHANNEL_STATS["cifar10"]


@pytest.fixture(scope="module")
def setup():
    mp = pytest.MonkeyPatch()
    torch_tiny.register(mp)
    mp.setattr(jbn, "jnp", torch_tiny.F64Numpy())
    rng = np.random.default_rng(8)
    images = rng.integers(0, 256, (70, *SHAPE)).astype(np.uint8)
    labels = rng.integers(0, L, 70)
    jmodel = JBuildNet(name="tinycnn", head="mlp", feat_dim=8,
                       num_classes=L)
    params = torch_tiny.flax_init(jmodel, SHAPE, dtype=jnp.float64)
    tx = joptim.make_optimizer(joptim.make_lr_schedule(**SCHEDULE))
    jstate = jtrainer.TrainState(params, {}, jax.jit(tx.init)(params),
                                 jnp.zeros((), jnp.int32))

    def port_state():
        model = BuildNet("tinycnn", head="mlp", feat_dim=8, num_classes=L)
        model.load_state_dict(torch_tiny.carry(params))
        return create_train_state(model.double(),
                                  make_lr_schedule(**SCHEDULE), device="cpu")

    yield dict(images=images, labels=labels, jmodel=jmodel, tx=tx,
               jstate=jstate, port_state=port_state,
               data=torch.from_numpy(images.reshape(70, -1)))
    mp.undo()


# base and batch rows (disjoint: a repeated row has d2 = 0 to its twin)
BATCHES = [(np.arange(0, 24, 3), np.array([1, 4, 8, 10, 30, 33, 41, 44,
                                           50, 51, 60, 61, 62, 65, 68,
                                           69])),
           (np.arange(1, 25, 3), np.arange(40, 56))]


def test_from_data_steps_match_jax_f64(setup):
    """The resident data here is already normalized (float64, norm=None):
    inside a jitted program XLA normalizes uint8 with a reciprocal multiply
    that differs from the eager float32 formula by one float32 ulp on most
    entries, and this graph's Laplacian turns that into ~5e-8 of the loss.
    The uint8 path is held to the host step bit for bit below."""
    s = setup
    jgl = jtrainer.make_gl_train_step_from_data(
        s["jmodel"], s["tx"], L, SHAPE, tau=TAU, epsilon="auto", k=K)
    jmlp = jtrainer.make_mlp_train_step_from_data(s["jmodel"], s["tx"],
                                                  SHAPE)
    gl = make_gl_train_step_from_data(L, SHAPE, tau=TAU, k=K, device="cpu")
    mlp = make_mlp_train_step_from_data(SHAPE, device="cpu")
    data = normalize_batch(s["images"], *NORM).reshape(70, -1)
    data_j = jnp.asarray(data, jnp.float64)
    data_t = torch.from_numpy(data).double()
    key = jax.random.PRNGKey(0)

    jst, st = s["jstate"], s["port_state"]()
    for base, idx in BATCHES:
        jst, jm, jsc = jgl(jst, data_j, base, s["labels"][base], idx,
                           s["labels"][idx], key)
        st, m, sc = gl(st, data_t, torch.from_numpy(base),
                       s["labels"][base], torch.from_numpy(idx),
                       s["labels"][idx])
        assert abs(m["loss"].item() - float(jm["loss"])) <= \
            1e-8 * abs(float(jm["loss"]))
        assert int(m["chol_info"]) == 0
        np.testing.assert_allclose(sc.numpy(), np.asarray(jsc), rtol=1e-8,
                                   atol=1e-12)
    torch_tiny.assert_params_close(st.model, torch_tiny.carry(jst.params),
                                   1e-8)

    jst, st = s["jstate"], s["port_state"]()
    for _, idx in BATCHES:
        jst, jm = jmlp(jst, data_j, idx, s["labels"][idx], key)
        st, m = mlp(st, data_t, torch.from_numpy(idx), s["labels"][idx])
        assert abs(m["loss"].item() - float(jm["loss"])) <= \
            1e-8 * abs(float(jm["loss"]))
    torch_tiny.assert_params_close(st.model, torch_tiny.carry(jst.params),
                                   1e-8)


def test_from_data_steps_equal_host_steps_bitwise(setup):
    s = setup
    imgs, labels = s["images"], s["labels"]
    gl_kw = dict(tau=TAU, k=K, norm=NORM, device="cpu")
    pairs = [(True, make_gl_train_step_from_data(L, SHAPE, **gl_kw),
              make_gl_train_step(L, **gl_kw)),
             (False,
              make_mlp_train_step_from_data(SHAPE, norm=NORM, device="cpu"),
              make_mlp_train_step(norm=NORM, device="cpu"))]
    for is_gl, from_data, host in pairs:
        a, b = s["port_state"](), s["port_state"]()
        for base, idx in BATCHES:
            if is_gl:
                a, ma, *_ = from_data(a, s["data"], base, labels[base], idx,
                                      labels[idx])
                b, mb, *_ = host(b, imgs[base], labels[base], imgs[idx],
                                 labels[idx])
            else:
                a, ma = from_data(a, s["data"], idx, labels[idx])
                b, mb = host(b, imgs[idx], labels[idx])
            assert torch.equal(ma["loss"], mb["loss"])
        for (name, pa), pb in zip(a.model.named_parameters(),
                                  b.model.parameters()):
            assert torch.equal(pa, pb), name


def test_encode_resident_equals_streaming_bitwise(setup):
    state = setup["port_state"]()
    step = make_encode_step(norm=NORM, device="cpu")
    for n, batch in ((70, 32), (45, 16)):     # ragged tails of 6 and 13
        calls = []
        stream = harness.encode_dataset(step, state, setup["images"][:n],
                                        batch_size=batch)
        enc = harness.make_encode_step_from_data(SHAPE, batch, norm=NORM,
                                                 device="cpu")
        res = harness.encode_dataset_resident(state, setup["data"], n, SHAPE,
                                              NORM, batch_size=batch,
                                              device="cpu")
        assert res.shape == (n, 8) and res.dtype == torch.float64
        assert torch.equal(res, stream)
        for start in range(0, n, batch):
            calls.append(len(enc(state, setup["data"],
                                 min(start, n - batch))))
        assert calls == [batch] * -(-n // batch)


def test_resident_transductive_matches_streaming(setup, monkeypatch):
    state = setup["port_state"]()
    imgs, labels = setup["images"], setup["labels"]
    train, test = imgs[:56], imgs[56:]
    base_sel = np.random.default_rng(1).permutation(56)[:8]
    seen = []
    solve = harness.transductive_laplace

    def capture(x, y, **kw):
        out = solve(x, y, **kw)
        seen.append((x, y, out[0]))
        return out

    monkeypatch.setattr(harness, "transductive_laplace", capture)
    kw = dict(train_images=train, knn_num=8, norm=NORM, batch_size=16,
              device="cpu")
    args = (state, train[base_sel], labels[base_sel], test, labels[56:],
            None, L)
    acc = harness.test_gl_transductive(*args, **kw)
    stats = {}
    acc_res = harness.test_gl_transductive(
        *args, resident=(setup["data"][:56], setup["data"][56:], base_sel,
                         SHAPE), stats=stats, **kw)
    assert acc_res == acc and stats["n_nodes"] == 8 + 56 + 14
    assert stats["cg_err"] <= 1e-10
    (x0, y0, u0), (x1, y1, u1) = seen
    assert torch.equal(x0, x1) and torch.equal(y0, y1)
    assert torch.equal(u0.argmax(1), u1.argmax(1))
    with pytest.raises(ValueError, match="norm"):
        harness.test_gl_transductive(*args, **dict(kw, norm=None),
                                     resident=(setup["data"][:56],
                                               setup["data"][56:], base_sel,
                                               SHAPE))


@pytest.fixture()
def tiny_opt(tmp_path, monkeypatch):
    torch_tiny.register(monkeypatch)
    monkeypatch.setattr(fullysup, "_records_and_plots",
                        lambda folder, records: None)
    monkeypatch.chdir(tmp_path)
    return ["--dev", "cpu", "--sup_train_type", "gl",
            "--dataset", "synthetic", "--model", "tinycnn", "--epochs", "3",
            "--batch_size", "32", "--num_train", "10", "--knn_k", "6",
            "--synth_n_train", "96", "--synth_n_test", "32",
            "--num_workers", "0", "--plot_freq_ss", "100",
            "--epsilon", "auto", "--viz_max_n", "0", "--device_data",
            "--augment_type_sup", "weak"]


def test_fullysup_device_data_never_augments_on_the_host(tiny_opt,
                                                         monkeypatch):
    """--device_data keeps the splits on the device: the host loader's
    augmentation never runs, each step sends index and label vectors, and
    both branches train; the MLP branch's loss falls over 3 epochs.

    The GL branch is held to finite losses and converged evals only: at
    this size its loss does not fall reliably in either framework (the JAX
    driver's test config goes 7.86 -> 6.63 at seed 42 and 6.78 -> 9.70 at
    seed 1; the port's runs at seeds 0-5 rise as often)."""
    calls = []
    orig = pipeline.BatchLoader._augment_batch

    def recording(self, batch, rng=None):
        calls.append(len(batch))
        return orig(self, batch, rng)

    monkeypatch.setattr(pipeline.BatchLoader, "_augment_batch", recording)
    sent = []
    step = fullysup.make_gl_train_step_from_data

    def spy(*a, **kw):
        inner = step(*a, **kw)

        def run(state, data, base_idx, base_labels, idx, labels):
            sent.append((type(idx), idx.shape, labels.shape))
            return inner(state, data, base_idx, base_labels, idx, labels)

        return run

    monkeypatch.setattr(fullysup, "make_gl_train_step_from_data", spy)
    rec = fullysup.run_training(parse_option(tiny_opt))
    assert calls == [] and rec["loader_backend"] == "device"
    assert len(rec["loss"]) == 3 and all(np.isfinite(rec["loss"]))
    assert sent == [(np.ndarray, (32,), (32,))] * 9
    assert len(rec["eval"]) == 2                  # epoch 0 and the last
    assert all(e["cg_err"] <= 1e-10 and e["n_nodes"] == 10 + 96 + 32
               for e in rec["eval"])

    rec = fullysup.run_training(parse_option(
        [a if a != "gl" else "mlp" for a in tiny_opt]
        + ["--learning_rate", "0.05"]))
    assert calls == [] and len(rec["loss"]) == 3
    assert rec["loss"][-1] < rec["loss"][0]


def test_fullysup_device_data_order_stream(tiny_opt, monkeypatch):
    """The device path's batches are the permutations of
    default_rng(seed * 7919 + 1), one an epoch, as in the JAX driver."""
    seen = []
    step = fullysup.make_mlp_train_step_from_data

    def spy(*a, **kw):
        inner = step(*a, **kw)

        def run(state, data, idx, labels):
            seen.append(np.asarray(idx))
            return inner(state, data, idx, labels)

        return run

    monkeypatch.setattr(fullysup, "make_mlp_train_step_from_data", spy)
    opt = parse_option([a if a != "gl" else "mlp" for a in tiny_opt]
                       + ["--epochs", "2"])
    fullysup.run_training(opt)
    rng = np.random.default_rng(opt.seed * 7919 + 1)
    perms = [rng.permutation(96) for _ in range(2)]
    want = [p[i * 32:(i + 1) * 32] for p in perms for i in range(3)]
    assert len(seen) == 6
    for got, w in zip(seen, want):
        np.testing.assert_array_equal(got, w)
