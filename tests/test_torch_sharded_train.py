"""The four sharded train steps over two gloo CPU ranks, against the JAX
package's ``make_sharded_*`` steps on a two-device mesh and against the
port's unsharded steps (the contract of tests/test_sharded_train.py: one
sharded step equals the unsharded step).

The model is that test's tiny encoder with one BatchNorm after the conv
(``tests/torch_ranks.py::TEnc``, a flax twin here), in float64; 16 base +
32 batch 12x12x1 images, 3 classes, k=5, tau 0.07.  The from-data steps are
held against JAX without augmentation (the two frameworks draw different
random numbers), and with the port's on-card augmentation against the
port's unsharded step at the same generator seed.  Tolerances in float64:
loss 1e-6 relative (the issue's bar; the port lands far inside it),
parameters and BN running statistics 1e-8, scores 1e-8 against JAX and
1e-10 against the port's unsharded step.  The running variance is
compared after torch's unbiased factor N/(N-1).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.models import l2_normalize as jl2
from graphlearninglayer_tpu.parallel import make_mesh as jmake_mesh
from graphlearninglayer_tpu.train import trainer as jtr
from graphlearninglayer_tpu.train.optim import (make_lr_schedule as jsched,
                                                make_optimizer as jopt)
from graphlearninglayer_tpu_torch.parallel import spawn_ranks
from tests import torch_ranks

H, BASE, BATCH, NDATA = 12, 16, 32, 64


class JEnc(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = True):
        x = fnn.Conv(8, (3, 3), strides=2, padding=1)(x)
        x = fnn.BatchNorm(use_running_average=not train, momentum=0.9,
                          epsilon=1e-5)(x)
        x = jnp.mean(fnn.relu(x), axis=(1, 2))
        feat = fnn.Dense(16)(x)
        return fnn.softmax(fnn.Dense(3)(feat)), jl2(feat)


def _to_port(params, stats) -> dict:
    a = lambda v: np.asarray(v, np.float64)
    return {"conv.weight": np.transpose(a(params["Conv_0"]["kernel"]),
                                        (3, 2, 0, 1)),
            "conv.bias": a(params["Conv_0"]["bias"]),
            "bn.weight": a(params["BatchNorm_0"]["scale"]),
            "bn.bias": a(params["BatchNorm_0"]["bias"]),
            "bn.running_mean": a(stats["BatchNorm_0"]["mean"]),
            "bn.running_var": a(stats["BatchNorm_0"]["var"]),
            "bn.num_batches_tracked": np.asarray(0),
            "feat.weight": a(params["Dense_0"]["kernel"]).T,
            "feat.bias": a(params["Dense_0"]["bias"]),
            "head.weight": a(params["Dense_1"]["kernel"]).T,
            "head.bias": a(params["Dense_1"]["bias"])}


@pytest.fixture(scope="module")
def run():
    rng = np.random.default_rng(0)
    inp = dict(image_shape=(H, H, 1),
               base_x=rng.normal(size=(BASE, H, H, 1)),
               base_y=rng.integers(0, 3, BASE),
               x=rng.normal(size=(BATCH, H, H, 1)),
               y=rng.integers(0, 3, BATCH),
               data=rng.normal(size=(NDATA, H * H)),
               data_u8=rng.integers(0, 256, (NDATA, H * H)).astype(np.uint8),
               perm=rng.permutation(NDATA))
    # disjoint base and batch rows: a row in both would put coincident
    # nodes in the graph, whose order among equal distances the two
    # frameworks break differently
    inp["base_idx"] = inp["perm"][:BASE]
    inp["idx"] = inp["perm"][BASE:BASE + BATCH]

    model = JEnc()
    tx = jopt(jsched(0.1, 5, 5))
    key = jax.random.PRNGKey(0)
    st = jtr.create_train_state(model, tx, key,
                                jnp.zeros((1, H, H, 1), jnp.float64))
    f64 = lambda t: jax.tree_util.tree_map(
        lambda v: jnp.asarray(v, jnp.float64), t)
    params, stats = f64(st.params), f64(st.batch_stats)
    st = jtr.TrainState(params, stats, tx.init(params), st.step)
    sd0 = _to_port(params, stats)

    mesh = jmake_mesh(2, axes=("data", "graph"))
    j = {}
    with mesh:
        gl = jtr.make_sharded_gl_train_step(model, tx, 3, mesh, tau=0.07,
                                            k=5)
        j["gl"] = gl(st, inp["base_x"], inp["base_y"], inp["x"], inp["y"],
                     key)
        mlp = jtr.make_sharded_mlp_train_step(model, tx, mesh)
        j["mlp"] = mlp(st, inp["x"], inp["y"], key) + (None,)
        gld = jtr.make_sharded_gl_train_step_from_data(
            model, tx, 3, (H, H, 1), mesh, tau=0.07, k=5)
        j["gl_data"] = gld(st, inp["data"], inp["base_idx"], inp["base_y"],
                           inp["idx"], inp["y"], key)
        mlpd = jtr.make_sharded_mlp_train_step_from_data(model, tx,
                                                         (H, H, 1), mesh)
        j["mlp_data"] = mlpd(st, inp["data"], inp["idx"], inp["y"],
                             key) + (None,)
    jax_out = {name: dict(loss=float(m["loss"]), acc=float(m["acc"]),
                          scores=None if s is None else np.asarray(s),
                          sd=_to_port(s1.params, s1.batch_stats))
               for name, (s1, m, s) in j.items()}

    torch.set_num_threads(1)
    ranks = spawn_ranks(torch_ranks.train_worker, 2, (sd0, inp),
                        device="cpu", threads=1)
    plain = torch_ranks.run_train_cases(sd0, inp)
    return dict(jax=jax_out, ranks=ranks, plain=plain)


def _close_sd(got: dict, want: dict, n_bn: int | None, atol: float):
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        g = got[key]
        if key == "bn.running_var" and n_bn is not None:
            # flax moves the running variance with the biased batch
            # variance, torch with the unbiased one (0.9 = 1 - momentum)
            w = 0.9 * 1.0 + (w - 0.9 * 1.0) * n_bn / (n_bn - 1)
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


@pytest.mark.parametrize("case", ["gl", "mlp", "gl_data", "mlp_data"])
def test_sharded_step_matches_jax_sharded_step(run, case):
    got, want = run["ranks"][0][case], run["jax"][case]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    assert got["acc"] == pytest.approx(want["acc"])
    if want["scores"] is not None:
        np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-8)
    rows = (BASE + BATCH) if case.startswith("gl") else BATCH
    _close_sd(got["sd"], want["sd"], rows * (H // 2) ** 2, 1e-8)
    assert int(got["sd"]["bn.num_batches_tracked"]) == 1


@pytest.mark.parametrize("case", ["gl", "mlp", "gl_data", "mlp_data",
                                  "gl_aug", "mlp_aug"])
def test_sharded_step_matches_unsharded_step(run, case):
    r0, r1, plain = (run["ranks"][0][case], run["ranks"][1][case],
                     run["plain"][case])
    # every rank holds the same step: one loss, one update, the full scores
    assert r0["loss"] == r1["loss"]
    for key in r0["sd"]:
        np.testing.assert_array_equal(r0["sd"][key], r1["sd"][key])
    np.testing.assert_allclose(r0["loss"], plain["loss"], rtol=1e-12)
    if plain["scores"] is not None:
        assert r0["scores"].shape == (BATCH,)
        np.testing.assert_array_equal(r0["scores"], r1["scores"])
        np.testing.assert_allclose(r0["scores"], plain["scores"], atol=1e-10)
    _close_sd(r0["sd"], plain["sd"], None, 1e-10)
