"""encode_s.eval: the harness's own encode time (stats["encode_s"], host
clock ending in a sync), mean over the traced evals."""


def read(ctx):
    if ctx["unit"] != "eval" or not ctx["eval_stats"]:
        return None
    s = [e["encode_s"] for e in ctx["eval_stats"]]
    return sum(s) / len(s)
