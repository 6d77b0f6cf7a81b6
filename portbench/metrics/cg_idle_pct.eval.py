"""cg_idle_pct.eval: the share of the ``eval.cg`` spans' intervals in
which no kernel ran on the device: what the host's per-iteration check
and launches leave idle (common/spans.py)."""
from portbench.common import spans


def read(ctx):
    if ctx["unit"] != "eval":
        return None
    t = spans.span_table(ctx)
    if t is None or not t.get("eval.cg", {}).get("host_s"):
        return None
    return 100.0 * t["eval.cg"]["idle_s"] / t["eval.cg"]["host_s"]
