"""k1_roofline_pct.train: K1's least time at the step's n and feature
width (common/counts.py::k1_bound_ms) over its mean device time a launch
in the traced steps."""
from portbench.common.counts import k1_bound_ms


def read(ctx):
    if ctx["unit"] != "train" or not ctx.get("k1_launches"):
        return None
    k1_s = ctx["profile"]["group_s"].get("k1_affinity", 0.0)
    if k1_s <= 0:
        return None
    per_launch_ms = 1e3 * k1_s / ctx["k1_launches"]
    return 100.0 * k1_bound_ms(ctx["k1_n"], ctx["feat_dim"])[0] / per_launch_ms
