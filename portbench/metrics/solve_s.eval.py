"""solve_s.eval: the harness's own graph-and-solve time (stats["solve_s"],
host clock ending in a sync), mean over the traced evals."""


def read(ctx):
    if ctx["unit"] != "eval" or not ctx["eval_stats"]:
        return None
    s = [e["solve_s"] for e in ctx["eval_stats"]]
    return sum(s) / len(s)
