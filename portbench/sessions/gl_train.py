"""FullySup GL training steps back to back (`train/trainer.py::
make_gl_train_step`), as `train/fullysup.py --sup_train_type gl` runs them:
base + batch rows encoded together, the dense graph op with the base
labels, the custom CE, one SGD update.

The batches are normalized NHWC float32 rows of a device-resident set,
drawn in a seeded order (every row once an epoch) and gathered on the
device; the base rows stay fixed.  Set-up drives the program through its
first three steps (the steps that `correct` compares) and the traffic's
warm-up steps; the window then runs steps with no host sync.
"""
from __future__ import annotations

import math

import torch

from ..common import check, counts, inputs, profile
from ..reference import laplace
from ..reference import train as ref


def taken_grads(optimizer, model) -> dict:
    """Each leaf's gradient as the optimizer took it in its first step,
    from its state: SGD's momentum buffer (gradient plus weight decay),
    Adam's first moment over (1 - beta1); zero where it kept none."""
    out = {}
    for name, p in model.named_parameters():
        st = optimizer.state[p]
        if "momentum_buffer" in st:
            out[name] = st["momentum_buffer"].detach().clone()
        elif "exp_avg" in st:
            beta1 = optimizer.param_groups[0]["betas"][0]
            out[name] = st["exp_avg"].detach() / (1.0 - beta1)
        else:
            out[name] = torch.zeros_like(p.detach())
    return out


def cosine_lr(cfg: dict, step: int, steps_per_epoch: int) -> float:
    """The reference's cosine schedule, held for an epoch (1-based)."""
    lr = cfg["lr"]
    eta_min = lr * cfg["lr_decay_rate"] ** 3
    epoch = step // steps_per_epoch + 1
    return eta_min + (lr - eta_min) * (
        1 + math.cos(math.pi * epoch / cfg["epochs"])) / 2


class Session:
    unit = "train"

    def __init__(self, cfg, traffic, encoder, seed, device):
        self.cfg, self.traffic, self.encoder = cfg, traffic, encoder
        self.dev = torch.device(device)
        self.gen = inputs.generator(seed, self.dev)
        images, self.labels = inputs.synthetic_images(
            cfg["train_images"], cfg["image_shape"], cfg["num_classes"],
            self.gen, self.dev)
        self.data = self.layout(inputs.normalize(images, cfg["mean"],
                                                 cfg["std"]))
        del images
        base = inputs.base_indices(self.labels, cfg["base_per_class"],
                                   cfg["num_classes"], seed)
        self.base_x = self.data.index_select(0, base)
        self.base_y = self.labels.index_select(0, base)
        self.batch = cfg["batch_size"]
        self.steps_per_epoch = cfg["train_images"] // self.batch
        self.model = encoder.program_model(cfg).to(self.dev)
        self.weights = inputs.FlatParams(self.model, self.gen, self.dev)
        self.weights.load(self.model)
        self.p0 = {n: t.clone() for n, t in self.weights.params.items()}
        self._order, self._pos = None, 0
        self.check_rows: list = []
        self.log: list = []

    @staticmethod
    def layout(data: torch.Tensor) -> torch.Tensor:
        """The resident set as the step takes it: NHWC rows, as the
        driver's batches arrive."""
        return data

    # -- the program ---------------------------------------------------------
    def _rows(self) -> torch.Tensor:
        n = self.cfg["train_images"]
        if self._order is None or self._pos + self.batch > n:
            self._order = torch.randperm(n, generator=self.gen,
                                         device=self.dev)
            self._pos = 0
        rows = self._order[self._pos:self._pos + self.batch]
        self._pos += self.batch
        return rows

    def build(self):
        from graphlearninglayer_tpu_torch.train.optim import make_lr_schedule
        from graphlearninglayer_tpu_torch.train.trainer import (
            create_train_state, make_gl_train_step)

        cfg = self.cfg
        schedule = make_lr_schedule(cfg["lr"], cfg["epochs"],
                                    self.steps_per_epoch, cosine=True,
                                    lr_decay_rate=cfg["lr_decay_rate"])
        self.state = create_train_state(
            self.model, schedule, device=self.dev, adam=False,
            momentum=cfg["momentum"], weight_decay=cfg["weight_decay"])
        self.step_fn = make_gl_train_step(
            cfg["num_classes"], tau=cfg["tau"], epsilon=cfg["epsilon"],
            k=cfg["knn_k"], solver=cfg["solver"], norm=None, device=self.dev)

    def step(self, rows=None):
        rows = self._rows() if rows is None else rows
        images = self.data.index_select(0, rows)
        labels = self.labels.index_select(0, rows)
        self.state, m, _ = self.step_fn(self.state, self.base_x, self.base_y,
                                        images, labels)
        self.log.append((m["loss"], m["chol_info"]))

    def start(self):
        """Build the program, drive it through the three steps that
        `correct` compares, then the warm-up steps."""
        self.start_checked()
        for _ in range(self.traffic["warmup_steps"]):
            self.step()

    def start_checked(self):
        """Build the program and drive it through the three compared
        steps, keeping the model's parameters and buffers as each step
        starts, what its encoder was given and fed the graph op on each
        call (a forward hook), and the op's neighbour lists (a wrapper on
        the dense mode's ``knn``)."""
        from graphlearninglayer_tpu_torch.ops import dense_mode

        self.build()
        states: list = []
        fed: list = []
        hook = self.model.register_forward_hook(
            lambda m, args, out: fed.append((states[-1], args[0].detach(),
                                             out[1].detach(), m.training)))
        tap = check.Tap(dense_mode, "knn", keep_all=True)
        try:
            for t in range(3):
                states.append({n: v.detach().clone() for n, v in
                               self.model.state_dict().items()})
                rows = self._rows()
                self.check_rows.append(rows)
                self.step(rows)
                if t == 0:
                    self.grad = taken_grads(self.state.optimizer, self.model)
        finally:
            hook.remove()
            tap.close()
        self.fed = fed
        self.calls = [(x, f, out[0]) for (_, x, f, _), out in
                      zip(fed, tap.outs)]
        self.losses = [float(loss) for loss, _ in self.log]
        self.change = {n: p.detach() - self.p0[n]
                       for n, p in self.model.named_parameters()}

    def window(self, seconds: float) -> dict:
        self.log = []
        r = check.timed_steps(self.step, seconds, self.dev)
        return {"train_images_per_s": r["steps"] * self.batch
                / r["window_s"],
                "train_step_p95_ms": _percentile(sorted(r["step_ms"]), 95)}

    def tally(self) -> tuple[int, int]:
        """(steps since the window opened, those whose loss is not finite
        or whose Cholesky factorization failed)."""
        loss = torch.stack([a for a, _ in self.log])
        info = torch.stack([b for _, b in self.log])
        return len(self.log), int((~torch.isfinite(loss) | (info != 0)).sum())

    def trace(self) -> dict:
        """A profiled window of the traffic's trace steps, and what the
        per-layer readers need beside it."""
        from graphlearninglayer_tpu_torch.ops.kernels import affinity

        k1 = affinity.fused_affinity_sym
        before, self.log = k1.launches, []
        n = self.traffic["trace_steps"]
        prof = profile.profile_window(self.step, n, profile.PROFILE_GROUPS)
        return {"unit": "train", "profile": prof, "steps": n,
                "k1_launches": k1.launches - before,
                "k1_n": len(self.base_y) + self.batch,
                "feat_dim": self.cfg["feat_dim"],
                "ideal_s": (self.flops_per_step()
                            / counts.PEAK_TF32_FLOP_PER_S)}

    def flops_per_step(self) -> float:
        return counts.train_step_flops(len(self.base_y) + self.batch,
                                       self.encoder.layers(self.cfg))

    def release(self):
        for name in ("state", "step_fn", "model", "calls"):
            setattr(self, name, None)

    # -- the comparison ------------------------------------------------------
    def subject(self) -> dict:
        return {"losses": self.losses, "grad": self.grad,
                "change": self.change, "fed": self.fed,
                "used": [(f, nbr) for _, f, nbr in self.calls]}

    def batches(self):
        return [(torch.cat([self.base_x, self.data.index_select(0, r)])
                 .permute(0, 3, 1, 2), self.base_y,
                 self.labels.index_select(0, r)) for r in self.check_rows]

    def lrs(self):
        return [cosine_lr(self.cfg, t, self.steps_per_epoch)
                for t in range(3)]

    def judge(self, subject: dict) -> dict:
        features = self.encoder.features
        return check.train_numbers(subject, ref.train_steps(
            features, self.p0, self.weights.buffers, self.batches(),
            self.cfg, self.lrs(), follow=subject["used"]), features,
            self.cfg)

    def diagnose(self, subject: dict) -> dict:
        """For the look behind ``loss_gap``, not compared: per compared
        step, the subject's loss and its gap to the float64 layer's on the
        same features and lists, the condition number of that layer's
        L_uu + tau I, and the smallest score a batch row gives its own
        class."""
        out = {}
        y = torch.nn.functional.one_hot(self.base_y.long(),
                                        self.cfg["num_classes"])
        for s, (f, nbr) in enumerate(subject["used"]):
            luu, rhs = laplace.dense_system(f.double(), y, nbr,
                                            self.cfg["tau"])
            pred = torch.linalg.solve(luu, rhs)
            labels = self.labels.index_select(0, self.check_rows[s]).long()
            loss = float(laplace.ce_loss(pred, labels))
            out[f"loss_{s + 1}"] = subject["losses"][s]
            out[f"loss_gap_{s + 1}"] = abs(subject["losses"][s] - loss) / loss
            out[f"cond_{s + 1}"] = float(torch.linalg.cond(luu))
            out[f"min_own_score_{s + 1}"] = float(
                pred.gather(1, labels[:, None]).min())
        return out

    def draw_check_rows(self):
        """The three compared steps' rows where no program drew them: the
        same draws from the seed as the program's first three steps."""
        if not self.check_rows:
            self.check_rows = [self._rows() for _ in range(3)]

    def variants(self) -> dict:
        """The control and the planted faults, each the reference put in
        the program's place on its own features and lists."""
        self.draw_check_rows()

        def run(prec="float32", keep=None):
            return ref.train_steps(self.encoder.features, self.p0,
                                   self.weights.buffers, self.batches(),
                                   self.cfg, self.lrs(), prec=prec,
                                   keep=keep)

        return {"control": lambda: run("bfloat16"),
                "fault_half_batch": lambda: run(keep=self.batch // 2)}


def _percentile(sorted_vals, q: float) -> float:
    """The q-th percentile of sorted values, linear between ranks."""
    pos = (len(sorted_vals) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(sorted_vals) - 1)
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (pos - lo)
