"""PGD-robust GL training steps back to back, through the adversarial
driver's own step (`train/adversarial_driver.py::make_train_step("gl",
"robust", ...)`), as its epoch loop runs them: five PGD iterations, each a
full graph-op forward and input gradient over the eval-mode encoder, then
the GL update on the perturbed batch; six op calls a step.

The data sits on the device as normalized NCHW float32, batches are row
gathers in a seeded order, as in the adversarial driver.  `correct` follows the
program step by step: PGD's sign turns rounding noise into +-alpha steps,
so the reference takes each PGD iterate the program produced (read by a
forward hook on the model during the three compared steps) and checks
the next one from its own gradient there, and the update steps run on the
batch the program perturbed.  The features of all eighteen encoder calls
are checked against the reference encoder's from the parameters and
buffers their step started from.
"""
from __future__ import annotations

import torch

from ..common import check, counts, inputs
from ..reference import train as ref
from .gl_train import Session as _GLTrain


class Session(_GLTrain):
    def __init__(self, cfg, traffic, encoder, seed, device):
        if cfg["knn_k"] != 25:
            raise ValueError("the adversarial driver's graph op takes k = 25")
        super().__init__(cfg, traffic, encoder, seed, device)
        self.seed = seed
        self.lo = torch.tensor(cfg["min_val"], device=self.dev)
        self.hi = torch.tensor(cfg["max_val"], device=self.dev)

    @staticmethod
    def layout(data: torch.Tensor) -> torch.Tensor:
        """The resident set as the driver keeps it: normalized NCHW."""
        return data.permute(0, 3, 1, 2).contiguous()

    def build(self):
        from graphlearninglayer_tpu_torch.train import adversarial_driver as ad
        from graphlearninglayer_tpu_torch.train.trainer import \
            create_train_state

        cfg = self.cfg
        acfg = ad.AdvConfig(
            dataset=cfg["dataset"], network_gl="resnet18",
            network_mlp="resnet18", min_val=cfg["min_val"],
            max_val=cfg["max_val"], pgd_epsilon=cfg["pgd_eps"],
            batch_size=self.batch, base_sample_rate=cfg["base_per_class"],
            lr=cfg["lr"], epochs=cfg["epochs"], adam=True,
            lr_gamma=cfg["lr_gamma"], lr_step=cfg["lr_step_epochs"],
            pgd_alpha=cfg["pgd_alpha"], pgd_iters=cfg["pgd_iters"],
            gl_tau=cfg["tau"])
        self.state = create_train_state(
            self.model, ad._make_schedule(acfg, self.steps_per_epoch),
            device=self.dev, **ad._make_tx(acfg, "gl"))
        self.pgd_gen = inputs.generator(self.seed + 1, self.dev)
        self.step_fn = ad.make_train_step(
            "gl", "robust", acfg, cfg["num_classes"], self.base_x,
            self.base_y, self.pgd_gen, self.lo, self.hi, self.dev)

    def step(self, rows=None):
        rows = self._rows() if rows is None else rows
        stats: list = []
        loss = self.step_fn(self.state, self.data.index_select(0, rows),
                            self.labels.index_select(0, rows), stats)
        info = torch.stack([s["chol_info"] for s in stats]).abs().amax()
        self.log.append((loss, info))

    def flops_per_step(self) -> float:
        n = len(self.base_y) + self.batch
        layers = self.encoder.layers(self.cfg)
        return (self.cfg["pgd_iters"] * counts.input_grad_flops(n, layers)
                + counts.train_step_flops(n, layers))

    # -- the comparison ------------------------------------------------------
    def subject(self) -> dict:
        """Per compared step, the encoder's six calls: five PGD iterates
        (eval mode) and the update's batch (train mode), each with the
        features and lists the graph op ran on, and the parameters and
        buffers the step started from."""
        nb, per = len(self.base_y), self.cfg["pgd_iters"] + 1
        steps = [self.calls[per * s:per * (s + 1)] for s in range(3)]
        return {"losses": self.losses, "grad": self.grad,
                "change": self.change, "fed": self.fed,
                "xs": [[x[nb:] for x, _, _ in calls] for calls in steps],
                "pgd_used": [(f, nbr) for _, f, nbr in steps[0][:-1]],
                "used": [calls[-1][1:] for calls in steps],
                "all_used": [(f, nbr) for _, f, nbr in self.calls]}

    def clean(self, s: int) -> torch.Tensor:
        return self.data.index_select(0, self.check_rows[s])

    def batches(self, xs):
        return [(torch.cat([self.base_x, x]), self.base_y,
                 self.labels.index_select(0, r))
                for x, r in zip(xs, self.check_rows)]

    def lrs(self):
        return [self.cfg["lr"]] * 3

    def judge(self, subject: dict) -> dict:
        """The train numbers of the three updates on the subject's
        perturbed batches, and of PGD: over the first step's iterates, the
        |gradient|-weighted share of elements whose next iterate differs
        from the reference's prediction (the reference's input gradient at
        the subject's iterate, on its features and lists), and every
        iterate's excess over the eps-ball and the data range."""
        cfg = self.cfg
        p = {**self.p0, **self.weights.buffers}
        labels0 = self.labels.index_select(0, self.check_rows[0])
        x0 = self.clean(0)
        features = self.encoder.features
        flip = 0.0
        for t in range(cfg["pgd_iters"]):
            xt, nxt = subject["xs"][0][t], subject["xs"][0][t + 1]
            g, _ = ref.input_grad(features, p, self.base_x, xt, self.base_y,
                                  labels0, cfg,
                                  follow=subject["pgd_used"][t])
            differ = ref.pgd_step(xt, g, x0, cfg, self.lo, self.hi) != nxt
            flip = max(flip, float(g.abs()[differ].sum() / g.abs().sum()))
        excess = 0.0
        for s in range(3):
            x = self.clean(s)
            for xt in subject["xs"][s]:
                out = torch.clamp((xt - x).abs() - cfg["pgd_eps"], min=0)
                out = torch.maximum(out, torch.maximum(self.lo - xt,
                                                       xt - self.hi))
                excess = max(excess, float(out.max()))
        numbers = check.train_numbers(subject, ref.train_steps(
            features, self.p0, self.weights.buffers,
            self.batches([xs[-1] for xs in subject["xs"]]), cfg, self.lrs(),
            follow=subject["used"]), features, cfg)
        numbers["knn_gap"] = max(check.knn_gap(f, nbr)
                                 for f, nbr in subject["all_used"])
        return {**numbers, "pgd_flip": flip, "pgd_ball_excess": excess}

    def reference_subject(self, prec="float32", keep=None) -> dict:
        """The reference in the program's place: its own PGD from a seeded
        start (at the initial weights and running statistics in each
        step: only the first step's iterates are judged), then its update
        steps on the batches it perturbed."""
        cfg = self.cfg
        p = {**self.p0, **self.weights.buffers}
        gen = inputs.generator(self.seed + 2, self.dev)
        xs, pgd_used, fed = [], [], []
        for s, r in enumerate(self.check_rows):
            x = self.clean(s)
            labels = self.labels.index_select(0, r)
            eps = cfg["pgd_eps"]
            noise = torch.rand(x.shape, generator=gen, device=self.dev)
            xt = torch.clamp(x + (2 * eps * noise - eps), self.lo, self.hi)
            seq = [xt]
            for _ in range(cfg["pgd_iters"]):
                g, used = ref.input_grad(self.encoder.features, p,
                                         self.base_x, xt, self.base_y,
                                         labels, cfg, prec=prec)
                pgd_used.append(used)
                if s == 0:
                    fed.append((p, torch.cat([self.base_x, xt]), used[0],
                                False))
                xt = ref.pgd_step(xt, g, x, cfg, self.lo, self.hi)
                seq.append(xt)
            xs.append(seq)
        run = ref.train_steps(self.encoder.features, self.p0,
                              self.weights.buffers,
                              self.batches([seq[-1] for seq in xs]), cfg,
                              self.lrs(), prec=prec, keep=keep)
        return {**run, "fed": fed + run["fed"], "xs": xs,
                "pgd_used": pgd_used[:cfg["pgd_iters"]],
                "all_used": pgd_used + run["used"]}

    def variants(self) -> dict:
        self.draw_check_rows()
        return {"control": lambda: self.reference_subject("bfloat16"),
                "fault_half_batch":
                    lambda: self.reference_subject(keep=self.batch // 2)}
