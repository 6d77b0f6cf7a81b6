"""The port's schedule, optimizer and loss against the JAX package's optax
chain and loss on the same numbers."""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graphlearninglayer_tpu.train import losses as jlosses
from graphlearninglayer_tpu.train import optim as joptim
from graphlearninglayer_tpu_torch.train import (custom_ce_loss,
                                                make_lr_schedule,
                                                make_optimizer)


@pytest.mark.parametrize("cosine,warm", [(True, False), (True, True),
                                         (False, False), (False, True)])
def test_schedule_matches_optax_over_epoch_grid(cosine, warm):
    kw = dict(learning_rate=0.05, epochs=12, steps_per_epoch=7, cosine=cosine,
              lr_decay_epochs=(4, 9), warm=warm, warm_epochs=3)
    want = joptim.make_lr_schedule(**kw)
    got = make_lr_schedule(**kw)
    steps = range(12 * 7 + 3)
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(jnp.asarray(s))) for s in steps],
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("adam", [False, True])
def test_updates_match_optax_chain(rng, adam):
    """Three updates from fixed gradients: the LambdaLR stepping and the
    coupled weight decay agree with optax's count and chain."""
    schedule_kw = dict(learning_rate=0.1, epochs=3, steps_per_epoch=1)
    p0 = rng.normal(size=(5, 4))
    grads = [rng.normal(size=(5, 4)) for _ in range(3)]

    tx = joptim.make_optimizer(joptim.make_lr_schedule(**schedule_kw),
                               adam=adam, weight_decay=5e-4)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    for g in grads:
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)

    pt = torch.nn.Parameter(torch.tensor(p0))
    opt, sched = make_optimizer([pt], make_lr_schedule(**schedule_kw),
                                adam=adam, weight_decay=5e-4)
    for g in grads:
        pt.grad = torch.tensor(g)
        opt.step()
        sched.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj),
                               atol=1e-12, rtol=1e-10)


def test_custom_ce_loss_matches_jax(rng):
    scores = rng.uniform(0, 1, size=(12, 5))
    scores[0, 2] = 0.0                       # the log clamp
    labels = rng.integers(0, 5, 12)
    labels[0] = 2
    want = float(jlosses.custom_ce_loss(jnp.asarray(scores),
                                        jnp.asarray(labels)))
    got = custom_ce_loss(torch.tensor(scores), torch.tensor(labels))
    assert abs(float(got) - want) <= 1e-12 * abs(want)
