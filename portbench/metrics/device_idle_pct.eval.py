"""device_idle_pct.eval: the share of the traced eval window in which no
kernel ran (100 - the union of kernel intervals over the window)."""


def read(ctx):
    if ctx["unit"] != "eval":
        return None
    p = ctx["profile"]
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
