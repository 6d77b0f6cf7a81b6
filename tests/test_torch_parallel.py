"""The port's multi-device package on gloo CPU ranks, against the JAX
package's on the conftest's virtual CPU devices, in float64.

* ``build_edge_shard_plan``: the same arrays, array for array, from the
  same (nbr, dist2), for 1-4 shards (no spawn: numpy on both sides);
* ``sharded_knn`` over 2 and 4 ranks: the JAX twin's lists exactly;
* ``edge_sharded_transductive_laplace`` over 2, 3 (dummy-node padding)
  and 4 ranks (several ring offsets) and ``sharded_transductive_laplace``
  over 2 and 3: the JAX twins' predictions within 1e-8, residual
  <= 1e-10; every rank returns the same scores (the JAX row-sharded twin
  builds its graph op by op, seconds a call, so it is held at two world
  sizes);
* the edge-sharded eval's cache: the second eval reuses the permutation
  (no k-means) and gives the cold solve's result;
* ``test_gl_transductive(mesh=...)``: graphs of at least ``shard_min_n``
  nodes take the edge-sharded route, smaller ones the single-device solve,
  both at the single-device eval's accuracy.

Each world size is spawned once (``tests/torch_ranks.py::parallel_worker``
runs all its cases), with one torch thread a rank.
"""
import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphlearninglayer_tpu.ops.knn import knn_tiled as jknn_tiled
from graphlearninglayer_tpu.parallel import edge_shard as jes
from graphlearninglayer_tpu.parallel import graph_shard as jgs
from graphlearninglayer_tpu.parallel import make_mesh as jmake_mesh
from graphlearninglayer_tpu_torch.models import BuildNet
from graphlearninglayer_tpu_torch.models import buildnet as tbn
from graphlearninglayer_tpu_torch.parallel import (build_edge_shard_plan,
                                                   spawn_ranks)
from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                make_lr_schedule)
from graphlearninglayer_tpu_torch.evalx import harness
from tests import torch_ranks


def _blobs(rng, n, d, n_blobs=8, spread=0.15):
    centers = rng.normal(size=(n_blobs, d)) * 4.0
    labels = rng.integers(0, n_blobs, n)
    return centers[labels] + spread * rng.normal(size=(n, d))


def _one_hot(rng, k_lab, l):
    return np.eye(l)[rng.integers(0, l, k_lab)]


def _cases(world: int) -> dict:
    rng = np.random.default_rng(world)
    cases = {}
    if world in (2, 4):
        cases["knn"] = dict(kind="knn", x=rng.normal(size=(256, 6)), k=9)
        x = _blobs(rng, 240, 6, n_blobs=16, spread=0.1)
        y = _one_hot(rng, 24, 4)
        kw = dict(knn_num=8, tau=1e-8, knn_block=64, n_clusters=16)
        cases["edge_clustered"] = dict(kind="edge", x=x, y=y, kw=kw)
    if world == 2:
        cases["graph"] = dict(kind="graph", x=rng.normal(size=(208, 5)),
                              y=_one_hot(rng, 24, 3),
                              kw=dict(knn_num=8, tau=1e-8, knn_block=64))
        cases["edge_unclustered"] = dict(
            kind="edge", x=rng.normal(size=(208, 5)), y=_one_hot(rng, 24, 3),
            kw=dict(knn_num=8, tau=1e-8, knn_block=64))
        cases["cache"] = dict(kind="cache", x=_blobs(rng, 256, 8, 4, 0.3),
                              y=_one_hot(rng, 32, 4), kw=dict(knn_num=8))
        cases["eval"] = _eval_case(rng)
    if world == 3:
        x, y = _blobs(rng, 203, 6), _one_hot(rng, 24, 3)
        cases["edge_padded"] = dict(kind="edge", x=x, y=y, kw=dict(
            knn_num=8, epsilon=1.0, tau=1e-6, knn_block=64))
        cases["graph_padded"] = dict(kind="graph", x=x, y=y, kw=dict(
            knn_num=8, epsilon=1.0, tau=1e-6, knn_block=64))
    return cases


@contextlib.contextmanager
def _tiny_registered():
    saved = tbn.model_dict.get("tinycnn")
    tbn.model_dict["tinycnn"] = (torch_ranks.ttiny, 16)
    try:
        yield
    finally:
        if saved is None:
            del tbn.model_dict["tinycnn"]
        else:
            tbn.model_dict["tinycnn"] = saved


def _eval_case(rng) -> dict:
    img = lambda n: rng.integers(0, 256, (n, 8, 8, 3)).astype(np.uint8)
    with _tiny_registered():
        model = BuildNet("tinycnn", head="mlp", feat_dim=8, num_classes=3,
                         generator=torch.Generator().manual_seed(0))
    return dict(kind="eval", classes=3,
                sd={k: v.double().numpy()
                    for k, v in model.state_dict().items()},
                base=(img(12), rng.integers(0, 3, 12)), train=img(40),
                test=(img(30), rng.integers(0, 3, 30)))


@pytest.fixture(scope="module")
def worlds():
    torch.set_num_threads(1)
    out = {}
    for world in (2, 3, 4):
        cases = _cases(world)
        out[world] = (cases, spawn_ranks(torch_ranks.parallel_worker, world,
                                         (cases,), device="cpu", threads=1))
    return out


def _same_on_every_rank(ranks, name, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name][key], ranks[0][name][key])


@pytest.mark.parametrize("nd", [1, 2, 3, 4])
def test_edge_shard_plan_equals_jax(nd):
    rng = np.random.default_rng(7)
    x = _blobs(rng, 240, 6, n_blobs=12, spread=0.2)[rng.permutation(240)]
    nbr, d2 = (np.asarray(a) for a in jknn_tiled(jnp.asarray(x), 8, 64))
    labeled = rng.permutation(240)[:20]
    y_full = np.zeros((240, 4))
    y_full[labeled, rng.integers(0, 4, 20)] = 1.0
    for eps in ("auto", 0.7):
        got = build_edge_shard_plan(nbr, d2, y_full, labeled, nd, 1e-8, eps)
        want = jes.build_edge_shard_plan(nbr, d2, y_full, labeled, nd, 1e-8,
                                         eps)
        assert got.offsets == want.offsets
        assert got.stats == want.stats
        assert len(got.req_send) == len(want.req_send)
        for a, b in zip(got.req_send, want.req_send):
            np.testing.assert_array_equal(a, b)
        for field in ("edge_dst", "edge_src", "edge_val", "diag", "mscale",
                      "rhs"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_knn_matches_jax(worlds, world):
    cases, ranks = worlds[world]
    c = cases["knn"]
    mesh = jmake_mesh(world, axes=("graph",))
    nbr, d2 = jes.sharded_knn(mesh, jnp.asarray(c["x"]), c["k"], "graph",
                              block=64)
    for r in ranks:
        np.testing.assert_array_equal(r["knn"]["nbr"], np.asarray(nbr))
        np.testing.assert_allclose(r["knn"]["dist2"], np.asarray(d2),
                                   atol=1e-12)
        assert r["knn"]["local_rows"] == 256 // world


@pytest.mark.parametrize("world,name", [
    (2, "edge_clustered"), (2, "edge_unclustered"), (3, "edge_padded"),
    (4, "edge_clustered")])
def test_edge_sharded_solve_matches_jax(worlds, world, name):
    cases, ranks = worlds[world]
    c = cases[name]
    want = jes.edge_sharded_transductive_laplace(
        jmake_mesh(world, axes=("graph",)), jnp.asarray(c["x"]),
        jnp.asarray(c["y"]), **c["kw"])
    got = ranks[0][name]
    assert got["pred"].shape == want.shape
    np.testing.assert_allclose(got["pred"], np.asarray(want), atol=1e-8)
    assert got["err"] <= 1e-10
    assert got["stats"]["nd"] == world
    _same_on_every_rank(ranks, name, "pred")
    if name == "edge_clustered" and world == 4:
        assert len(got["stats"]["ring_caps"]) >= 2   # several ring offsets


@pytest.mark.parametrize("world,name", [(2, "graph"), (3, "graph_padded")])
def test_row_sharded_solve_matches_jax(worlds, world, name):
    cases, ranks = worlds[world]
    c = cases[name]
    want = jgs.sharded_transductive_laplace(
        jmake_mesh(world, axes=("graph",)), jnp.asarray(c["x"]),
        jnp.asarray(c["y"]), **c["kw"])
    got = ranks[0][name]
    assert got["pred"].shape == want.shape
    np.testing.assert_allclose(got["pred"], np.asarray(want), atol=1e-8)
    assert got["err"] <= 1e-10
    _same_on_every_rank(ranks, name, "pred")


def test_edge_sharded_cache_reuses_the_permutation(worlds):
    cases, ranks = worlds[2]
    got = ranks[0]["cache"]
    assert got["kmeans_calls"] == 1 and got["shard_nd"] == 2
    c = cases["cache"]
    want = jes.edge_sharded_transductive_laplace(
        jmake_mesh(2, axes=("graph",)), jnp.asarray(c["x"]),
        jnp.asarray(c["y"]), **c["kw"])
    for pred in got["preds"]:
        np.testing.assert_allclose(pred, np.asarray(want), atol=1e-8)


def test_eval_mesh_routes_by_graph_size(worlds):
    cases, ranks = worlds[2]
    c = cases["eval"]
    with _tiny_registered():
        model = BuildNet("tinycnn", head="mlp", feat_dim=8, num_classes=3)
    model.load_state_dict({k: torch.tensor(v) for k, v in c["sd"].items()})
    state = create_train_state(model.double(), make_lr_schedule(0.1, 1, 1),
                               device="cpu")
    want = harness.test_gl_transductive(state, *c["base"], *c["test"], None,
                                        3, train_images=c["train"],
                                        knn_num=8, device="cpu")
    for r in ranks:
        got = r["eval"]
        assert got["sharded"]["route"] == "edge_sharded"
        assert "edge-sharded over 2 devices" in got["sharded"]["out"]
        assert got["single"]["route"] == "single"
        assert "edge-sharded" not in got["single"]["out"]
        assert got["sharded"]["acc"] == got["single"]["acc"] == want
