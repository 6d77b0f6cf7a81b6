"""plan_ms.eval: host ms an eval in ``eval.plan``: the BSR plan (from the
cache's permutation, or k-means afresh) and its slot and overflow
budgets, the host's read of the tile histogram included."""
from portbench.common import spans


def read(ctx):
    if ctx["unit"] != "eval":
        return None
    t = spans.span_table(ctx)
    if t is None or "eval.plan" not in t:
        return None
    return 1e3 * t["eval.plan"]["host_s"] / ctx["steps"]
