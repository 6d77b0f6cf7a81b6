"""k2_roofline_pct.eval: K2's least time at the eval's n, feature width and
k (common/counts.py::k2_bound_ms, one triangle of float32 FMA) over its
mean device time a launch in the traced evals."""
from portbench.common.counts import k2_bound_ms


def read(ctx):
    if ctx["unit"] != "eval" or not ctx.get("k2_launches"):
        return None
    k2_s = ctx["profile"]["group_s"].get("k2_knn", 0.0)
    if k2_s <= 0:
        return None
    per_launch_ms = 1e3 * k2_s / ctx["k2_launches"]
    return 100.0 * k2_bound_ms(ctx["k2_n"], ctx["feat_dim"],
                               ctx["k2_k"])[0] / per_launch_ms
