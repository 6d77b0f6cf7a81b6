"""Port-only pieces for the multi-rank CPU tests.

The tests spawn gloo ranks (``parallel.spawn_ranks``) that import this
module and the port, never JAX.  Each worker below runs every case of a
test file in one world, so that a file pays for one spawn a world size,
and returns numpy results that the test compares with the JAX package's in
the parent process.
"""
import contextlib
import io

import torch
import torch.nn as nn
import torch.nn.functional as F

from graphlearninglayer_tpu_torch.models import buildnet as tbn
from graphlearninglayer_tpu_torch.models import l2_normalize


class TTiny(nn.Module):
    """One stride-2 conv, a mean pool and a dense layer to 16 features (the
    JAX driver tests' tiny encoder)."""

    def __init__(self, in_channel: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(in_channel, 8, 3, stride=2, padding=1)
        self.dense = nn.Linear(8, 16)

    def forward(self, x):
        return l2_normalize(self.dense(torch.relu(self.conv(x))
                                       .mean(dim=(2, 3))))


def ttiny(in_channel: int = 3) -> TTiny:
    """A registry constructor that pickles into spawned ranks."""
    return TTiny(in_channel)


class TEnc(nn.Module):
    """tests/test_sharded_train.py's ``Enc`` with one BatchNorm after the
    conv: ``(softmax(dense(3)), l2-normalized 16 features)``."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(1, 8, 3, stride=2, padding=1)
        self.bn = nn.BatchNorm2d(8)
        self.feat = nn.Linear(8, 16)
        self.head = nn.Linear(16, 3)

    def forward(self, x):
        x = torch.relu(self.bn(self.conv(x))).mean(dim=(2, 3))
        feat = self.feat(x)
        return F.softmax(self.head(feat), dim=1), l2_normalize(feat)


def train_state(sd0: dict):
    """A float64 TEnc from ``sd0`` with the JAX test's optimizer."""
    from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                    make_lr_schedule)

    model = TEnc().double()
    model.load_state_dict({k: torch.tensor(v) for k, v in sd0.items()})
    return create_train_state(model, make_lr_schedule(0.1, 5, 5),
                              device="cpu")


def run_train_cases(sd0: dict, inp: dict, mesh=None) -> dict:
    """One step of each train step, sharded over ``mesh`` or (None) the
    unsharded steps on the CPU: loss, acc, scores and the state dict."""
    from graphlearninglayer_tpu_torch.data.device_aug import DeviceTransform
    from graphlearninglayer_tpu_torch.train import trainer as tr

    hw = inp["image_shape"]
    aug = DeviceTransform("synthetic", "weak")
    norm = (aug.mean, aug.std)
    gen = lambda: torch.Generator().manual_seed(3)
    gl_kw = dict(tau=0.07, k=5)
    if mesh is None:
        dev = dict(device="cpu")
        steps = {
            "gl": tr.make_gl_train_step(3, **gl_kw, **dev),
            "mlp": tr.make_mlp_train_step(**dev),
            "gl_data": tr.make_gl_train_step_from_data(3, hw, **gl_kw, **dev),
            "mlp_data": tr.make_mlp_train_step_from_data(hw, **dev),
            "gl_aug": tr.make_gl_train_step_from_data(
                3, hw, **gl_kw, norm=norm, aug=aug, generator=gen(), **dev),
            "mlp_aug": tr.make_mlp_train_step_from_data(
                hw, norm=norm, aug=aug, generator=gen(), **dev)}
    else:
        steps = {
            "gl": tr.make_sharded_gl_train_step(3, mesh, **gl_kw),
            "mlp": tr.make_sharded_mlp_train_step(mesh),
            "gl_data": tr.make_sharded_gl_train_step_from_data(
                3, hw, mesh, **gl_kw),
            "mlp_data": tr.make_sharded_mlp_train_step_from_data(hw, mesh),
            "gl_aug": tr.make_sharded_gl_train_step_from_data(
                3, hw, mesh, **gl_kw, norm=norm, aug=aug, generator=gen()),
            "mlp_aug": tr.make_sharded_mlp_train_step_from_data(
                hw, mesh, norm=norm, aug=aug, generator=gen())}
    data, data_u8 = torch.as_tensor(inp["data"]), torch.as_tensor(
        inp["data_u8"])
    args = {
        "gl": (inp["base_x"], inp["base_y"], inp["x"], inp["y"]),
        "mlp": (inp["x"], inp["y"]),
        "gl_data": (data, inp["base_idx"], inp["base_y"], inp["idx"],
                    inp["y"]),
        "mlp_data": (data, inp["idx"], inp["y"])}
    args["gl_aug"] = (data_u8,) + args["gl_data"][1:]
    args["mlp_aug"] = (data_u8,) + args["mlp_data"][1:]
    out = {}
    for name, step in steps.items():
        state = train_state(sd0)
        state, metrics, *scores = step(state, *args[name])
        out[name] = dict(
            loss=float(metrics["loss"]), acc=float(metrics["acc"]),
            scores=scores[0].numpy() if scores else None,
            sd={k: v.detach().numpy().copy()
                for k, v in state.model.state_dict().items()})
    return out


def train_worker(sd0: dict, inp: dict) -> dict:
    """The sharded train cases on the world's mesh (every rank)."""
    from graphlearninglayer_tpu_torch.parallel import make_mesh

    return run_train_cases(sd0, inp, make_mesh(axes=("data", "graph"),
                                               device="cpu"))


def parallel_worker(cases: dict) -> dict:
    """The sharded KNN, edge-sharded and row-sharded solves and the eval's
    mesh route on the world's 'graph' mesh; returns numpy results."""
    import graphlearninglayer_tpu_torch.ops.bsr as bsr
    import graphlearninglayer_tpu_torch.parallel.graph_shard as graph_shard
    from graphlearninglayer_tpu_torch.evalx import test_gl_transductive
    from graphlearninglayer_tpu_torch.models import BuildNet
    from graphlearninglayer_tpu_torch.ops import EvalGraphCache
    from graphlearninglayer_tpu_torch.parallel import (
        edge_sharded_transductive_laplace, make_mesh, sharded_knn,
        sharded_transductive_laplace)
    from graphlearninglayer_tpu_torch.train import (create_train_state,
                                                    make_lr_schedule)

    mesh = make_mesh(axes=("graph",), device="cpu")
    t = torch.as_tensor
    out = {}
    for name, c in cases.items():
        if c["kind"] == "knn":
            nbr, d2 = sharded_knn(mesh, t(c["x"]), c["k"], block=64,
                                  gather_out=True)
            loc, _ = sharded_knn(mesh, t(c["x"]), c["k"], block=64)
            out[name] = dict(nbr=nbr.numpy(), dist2=d2.numpy(),
                             local_rows=loc.shape[0])
        elif c["kind"] == "edge":
            pred, stats, iters, err = edge_sharded_transductive_laplace(
                mesh, t(c["x"]), t(c["y"]), **c["kw"], return_stats=True,
                return_info=True)
            out[name] = dict(pred=pred.numpy(), iters=iters, err=err,
                             stats=stats)
        elif c["kind"] == "graph":
            calls = []
            orig = graph_shard.ell_gather_spmm
            graph_shard.ell_gather_spmm = \
                lambda *a: calls.append(1) or orig(*a)
            pred, iters, err = sharded_transductive_laplace(
                mesh, t(c["x"]), t(c["y"]), **c["kw"], return_info=True)
            graph_shard.ell_gather_spmm = orig
            out[name] = dict(pred=pred.numpy(), iters=iters, err=err,
                             p3_calls=len(calls))
        elif c["kind"] == "cache":
            calls = []
            orig = bsr.kmeans
            bsr.kmeans = lambda *a, **k: calls.append(1) or orig(*a, **k)
            cache = EvalGraphCache()
            preds = [edge_sharded_transductive_laplace(
                mesh, t(c["x"]), t(c["y"]), **c["kw"], cache=cache).numpy()
                for _ in range(2)]
            bsr.kmeans = orig
            out[name] = dict(preds=preds, kmeans_calls=len(calls),
                             shard_nd=cache.shard_nd)
        elif c["kind"] == "eval":
            tbn.model_dict["tinycnn"] = (ttiny, 16)
            model = BuildNet("tinycnn", head="mlp", feat_dim=8,
                             num_classes=c["classes"]).double()
            model.load_state_dict({k: torch.tensor(v)
                                   for k, v in c["sd"].items()})
            state = create_train_state(model, make_lr_schedule(0.1, 1, 1),
                                       device="cpu")
            res = {}
            for route, min_n in (("sharded", 1), ("single", 10 ** 6)):
                buf, stats = io.StringIO(), {}
                with contextlib.redirect_stdout(buf):
                    acc = test_gl_transductive(
                        state, *c["base"], *c["test"], None, c["classes"],
                        train_images=c["train"], knn_num=8, mesh=mesh,
                        shard_min_n=min_n, stats=stats)
                res[route] = dict(acc=acc, out=buf.getvalue(),
                                  route=stats["route"])
            out[name] = res
    return out


def attack_case_run(case: dict, mesh=None) -> dict:
    """The FGSM and IFGSM attacks of ``case`` through the linear-tanh
    encoder of tests/test_torch_attacks.py, sharded over ``mesh`` or (None)
    unsharded on the CPU, with the first step's input gradient: numpy
    adversarial images, predictions and gradient rows (this rank's, from
    row ``lo`` of the batch, where sharded)."""
    from graphlearninglayer_tpu_torch.attack import fgsm

    t = {k: torch.as_tensor(case[k]) for k in ("base", "base_labels",
                                              "images", "labels")}
    w = torch.as_tensor(case["w"])

    def encode(x):
        return l2_normalize(torch.tanh(x @ w))

    op_kw = dict(tau=0.0, k=case["k"])
    make = fgsm.make_gl_fast_gradient_attack(encode, case["l"], device="cpu",
                                             mesh=mesh, **op_kw)
    _, batch = fgsm.gl_head(encode, case["l"], op_kw, t["base"],
                            t["base_labels"], len(case["labels"]), mesh)
    lo, hi = batch.lo, batch.hi
    loss = fgsm.gl_loss(encode, case["l"], op_kw, t["base"],
                        t["base_labels"], t["labels"], [], mesh)
    out = {"lo": lo, "grad": fgsm.input_grad(loss,
                                             t["images"][lo:hi]).numpy()}
    for kind in ("fgsm", "ifgsm"):
        stats = []
        adv, pred = make(t["base"], t["base_labels"], t["images"],
                         t["labels"], case["eps"], kind, -10.0, 10.0, stats)
        out[kind] = dict(adv=adv.numpy(), pred=pred.numpy(),
                         op_calls=len(stats))
    return out


def attack_worker(case: dict) -> dict:
    """The sharded attack cases on the world's mesh (every rank)."""
    from graphlearninglayer_tpu_torch.parallel import make_mesh

    return attack_case_run(case, make_mesh(axes=("data", "graph"),
                                           device="cpu"))
