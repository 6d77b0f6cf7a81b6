"""The transductive eval of a FullySup run, through
`evalx/harness.py::test_gl_transductive` on its resident route (the splits
as uint8 rows on the device, as `--device_data` runs it): encode base +
train + test, one k-NN graph over all of them (K2), the BSR plan and the
CG solve.  One `EvalGraphCache` serves every eval, as the driver keeps one
across evals.  Before each eval, as between two of the driver's evals, the
base set is drawn afresh (the driver's per-epoch refresh, 'random' mode)
and the weights drift by a seeded step of ``drift_sigma`` of their init
bounds, so that the features, the graph and the cache's reuse change; the
traffic's file says what that drift was set from.

The images and the starting weights are one fixed pool (the traffic's
``pool_seed``), as a user's data set is fixed: with both drawn from the
seed, the seed changed the CG's work (57-90 iterations an eval on six
seeds, an eval 0.78-0.84 s, where two runs of one seed agreed within
0.8%).  The seed orders the rows and draws every base set, every drift and
the compared eval.

`correct` judges one eval of the window, drawn from the seed: the
program's features against the reference encoder's on the same weights
and images, its k-NN lists against the exact lists of its own features,
and its scores against a float64 solve on its own lists and features,
with the labels of the base set it was handed.  The features, lists and
scores are read where the harness hands them to the next layer, by
wrappers that keep the latest call's arguments and result.
"""
from __future__ import annotations

import numpy as np
import torch

from ..common import check, counts, inputs, profile
from ..reference import laplace
from ..reference import train as ref_train


class Session:
    unit = "eval"

    def __init__(self, cfg, traffic, encoder, seed, device):
        self.cfg, self.traffic, self.encoder = cfg, traffic, encoder
        self.dev = torch.device(device)
        # the data set and the starting weights are one fixed pool, as a
        # user's data set is fixed; the seed orders its rows and draws the
        # base set, every drift and the compared eval
        pool = inputs.generator(traffic["pool_seed"], self.dev)
        self.gen = inputs.generator(seed, self.dev)
        n_train, n_test = cfg["train_images"], cfg["test_images"]
        images, labels = inputs.synthetic_images(
            n_train + n_test, cfg["image_shape"], cfg["num_classes"], pool,
            self.dev)
        self.model = encoder.program_model(cfg).to(self.dev)
        self.weights = inputs.FlatParams(self.model, pool, self.dev)
        order = torch.cat([
            torch.randperm(n_train, generator=self.gen, device=self.dev),
            n_train + torch.randperm(n_test, generator=self.gen,
                                     device=self.dev)])
        images, labels = images[order], labels[order]
        flat = images.reshape(len(images), -1)
        self.train_u8, self.test_u8 = flat[:n_train], flat[n_train:]
        labels_np = labels.cpu().numpy()
        self.train_labels = labels_np[:n_train]
        self.test_labels = labels_np[n_train:]
        self.by_class = [np.flatnonzero(self.train_labels == c)
                         for c in range(cfg["num_classes"])]
        self.base_rng = np.random.default_rng([seed, 1])
        self.sample = int(np.random.default_rng(seed).integers(
            traffic["compare_from"], traffic["compare_to"]))
        self.stats: list = []
        self.kept = None

    def build(self):
        from graphlearninglayer_tpu_torch.evalx import harness
        from graphlearninglayer_tpu_torch.ops import EvalGraphCache, graph
        from graphlearninglayer_tpu_torch.train.trainer import \
            create_train_state

        self.harness = harness
        self.state = create_train_state(self.model, lambda _: 0.0,
                                        device=self.dev)
        self.cache = EvalGraphCache()
        from graphlearninglayer_tpu_torch.ops import transductive

        self.taps = [check.Tap(harness, "transductive_laplace"),
                     check.Tap(graph, "knn_tiled"),
                     check.Tap(transductive, "bsr_plan")]
        self.n_evals = 0

    def draw_base(self) -> np.ndarray:
        """A fresh base set, ``base_per_class`` train rows of each class in
        class order, as the driver's 'random' refresh draws it."""
        per = self.cfg["base_per_class"]
        return np.concatenate([self.base_rng.permutation(rows)[:per]
                               for rows in self.by_class])

    def eval_once(self):
        """A fresh base set and one drift of the weights, then one eval;
        the sampled eval's weights, base set and the layers' outputs are
        kept for the comparison."""
        cfg = self.cfg
        base_rows = self.last_base = self.draw_base()
        base_labels = self.train_labels[base_rows]
        self.weights.drift(self.traffic["drift_sigma"], self.gen)
        self.weights.load(self.model)
        plans = self.taps[2].calls
        stats: dict = {}
        acc = self.harness.test_gl_transductive(
            self.state, base_rows, base_labels, self.test_u8,
            self.test_labels, None, cfg["num_classes"],
            knn_num=cfg["eval_knn_k"], epsilon=cfg["epsilon"],
            tau=cfg["eval_tau"], batch_size=cfg["eval_batch"],
            norm=(cfg["mean"], cfg["std"]),
            resident=(self.train_u8, self.test_u8, base_rows,
                      tuple(cfg["image_shape"])),
            cache=self.cache, device=self.dev, stats=stats)
        stats["acc"] = acc
        stats["fresh_plans"] = self.taps[2].calls - plans
        self.stats.append(stats)
        if self.n_evals == self.sample:
            solve, knn = self.taps[:2]
            self.kept = {"params": {n: t.clone() for n, t in
                                    self.weights.params.items()},
                         "base_rows": base_rows, "base_labels": base_labels,
                         "features": solve.args[0], "scores": solve.out[0],
                         "nbr": knn.out[0]}
        self.n_evals += 1

    def start(self):
        """Build the program and warm it up with the traffic's evals (the
        first fills the cache's plan)."""
        self.build()
        for _ in range(self.traffic["warmup_evals"]):
            self.eval_once()
        self.n_evals = 0

    def start_checked(self):
        """Build the program and run evals up to the compared one."""
        self.build()
        while self.kept is None:
            self.eval_once()

    def window(self, seconds: float) -> dict:
        self.stats = []
        r = check.timed_calls(self.eval_once, seconds, self.dev,
                              min_calls=self.sample + 1)
        return {"eval_s": r["window_s"] / r["calls"]}

    def context(self) -> str:
        """The window's plan rebuilds and CG iterations, beside the
        metrics."""
        n = len(self.stats)
        fresh = sum(s["fresh_plans"] for s in self.stats)
        iters = sum(s["cg_iters"] for s in self.stats) / max(n, 1)
        return (f"evals {n}, fresh BSR plans {fresh}, "
                f"CG iterations a solve {iters:.1f}")

    def tally(self) -> tuple[int, int]:
        """(evals since the window opened, those whose CG did not reach
        its tolerance or whose accuracy is not finite)."""
        failed = sum(1 for s in self.stats
                     if not (s["cg_err"] <= self.cfg["eval_cg_tol"]
                             and np.isfinite(s["acc"])))
        return len(self.stats), failed

    def trace(self) -> dict:
        from graphlearninglayer_tpu_torch.ops.kernels import knn_topk

        k2 = knn_topk.fused_knn
        before, self.stats = k2.launches, []
        n = self.traffic["trace_evals"]
        prof = profile.profile_window(self.eval_once, n, profile.EVAL_GROUPS,
                                      phase="eval")
        traced, launches = list(self.stats), k2.launches - before
        while self.kept is None:       # the compared eval comes after
            self.eval_once()
        self.stats = traced            # attempted: the traced evals
        return {"unit": "eval", "profile": prof, "steps": n,
                "k2_launches": launches, "k2_n": self.n_nodes(),
                "k2_k": self.cfg["eval_knn_k"],
                "feat_dim": self.cfg["feat_dim"],
                "ideal_s": self.ideal_s_per_eval(),
                "eval_stats": traced}

    def n_nodes(self) -> int:
        return (self.cfg["base_per_class"] * self.cfg["num_classes"]
                + len(self.train_u8) + len(self.test_u8))

    def ideal_s_per_eval(self) -> float:
        """An eval's least seconds at the card's peaks: the encoder's
        forward over train + test (the base rows are gathered from the
        train features) at the TF32 peak and the exact KNN's one triangle
        at the float32 peak; the CG solve's few GFLOP are left out."""
        n_enc = len(self.train_u8) + len(self.test_u8)
        return (counts.forward_flops(n_enc, self.encoder.layers(self.cfg))
                / counts.PEAK_TF32_FLOP_PER_S
                + counts.knn_one_triangle_flops(self.n_nodes(),
                                                self.cfg["feat_dim"])
                / counts.PEAK_F32_FLOP_PER_S)

    def release(self):
        for tap in getattr(self, "taps", []):
            tap.close()
        self.taps = []
        for name in ("state", "cache", "model", "harness"):
            setattr(self, name, None)

    # -- the comparison ------------------------------------------------------
    def subject(self) -> dict:
        return self.kept

    def reference_features(self, params, base_rows,
                           prec="float32") -> torch.Tensor:
        """Unit-norm features of base + train + test from ``params`` (and
        the initial running statistics), in blocks."""
        cfg = self.cfg
        p = {**params, **self.weights.buffers}
        shape = tuple(cfg["image_shape"])
        out = []
        with torch.no_grad(), ref_train.precision(prec, self.dev):
            for part in (self.train_u8, self.test_u8):
                for s in range(0, len(part), 1000):
                    x = inputs.normalize(part[s:s + 1000].reshape(-1, *shape),
                                         cfg["mean"], cfg["std"])
                    out.append(self.encoder.features(
                        p, x.permute(0, 3, 1, 2), cfg, False).float())
        f = torch.cat(out)
        base = torch.as_tensor(base_rows, device=self.dev)
        return torch.cat([f.index_select(0, base), f])

    def labels_onehot(self, base_labels) -> torch.Tensor:
        return torch.nn.functional.one_hot(
            torch.as_tensor(base_labels, device=self.dev).long(),
            self.cfg["num_classes"]).float()

    def judge(self, subject: dict) -> dict:
        """feat_gap: the subject's features against the reference
        encoder's from the same weights and images; knn_gap: its lists
        against the exact lists of its own features; score_gap: the worst
        |score - score_ref| over the largest |score_ref|, the reference
        solving in float64 on the subject's own lists and features with
        the labels of the base set it was handed."""
        cfg = self.cfg
        f, nbr = subject["features"], subject["nbr"]
        numbers = {"feat_gap": check.feat_gap(
            f, self.reference_features(subject["params"],
                                       subject["base_rows"]))}
        numbers["knn_gap"] = check.knn_gap(f, nbr)
        u_ref = laplace.eval_scores(nbr, laplace.edge_d2(f.double(), nbr),
                                    self.labels_onehot(
                                        subject["base_labels"]),
                                    cfg["eval_tau"])
        u = subject["scores"].double()
        numbers["score_gap"] = float((u - u_ref).abs().max()
                                     / u_ref.abs().max())
        return numbers

    def reference_subject(self, prec: str, solve: str) -> dict:
        """The reference in the program's place, on the first eval's base
        set and weights: features in ``prec``, k-NN lists ranked in it,
        then the solve in ``solve`` ('float64', or 'tf32' stopped as the
        program's CG is)."""
        cfg = self.cfg
        base_rows = self.draw_base()
        base_labels = self.train_labels[base_rows]
        self.weights.drift(self.traffic["drift_sigma"], self.gen)
        params = {n: t.clone() for n, t in self.weights.params.items()}
        f = self.reference_features(params, base_rows, prec)
        nbr = ref_train.select(f, cfg["eval_knn_k"], prec)
        u = laplace.eval_scores(nbr, laplace.edge_d2(f.double(), nbr),
                                self.labels_onehot(base_labels),
                                cfg["eval_tau"],
                                tol=(cfg["eval_cg_tol"] if solve == "tf32"
                                     else 1e-13),
                                max_iter=(5000 if solve == "tf32"
                                          else 100_000), prec=solve)
        return {"params": params, "base_rows": base_rows,
                "base_labels": base_labels, "features": f, "scores": u,
                "nbr": nbr}

    def variants(self) -> dict:
        """The control, each stage one step below the configuration's
        precision (the encoder's TF32 convolutions in bfloat16, the
        ranking on bfloat16 features, the float32 solve's products in
        TF32), and an answer altered where it is produced."""
        def altered():
            sub = self.reference_subject("float32", "float64")
            sub["scores"] = sub["scores"].clone()
            sub["scores"][0] = sub["scores"][0].flip(0)
            return sub

        return {"control": lambda: self.reference_subject("bfloat16",
                                                          "tf32"),
                "fault_answer_altered": altered}
