"""encoder_ms.train: device ms a traced step in the encoder's kernel
groups (convolutions, their layout transposes, batch norm)."""

GROUPS = ("conv", "conv_layout", "batchnorm")


def read(ctx):
    if ctx["unit"] != "train":
        return None
    g = ctx["profile"]["group_s"]
    total = sum(g.get(name, 0.0) for name in GROUPS)
    return 1e3 * total / ctx["steps"] if total > 0 else None
