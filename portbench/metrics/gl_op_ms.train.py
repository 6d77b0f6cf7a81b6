"""gl_op_ms.train: device ms a traced step in the graph op's kernel groups
(K1's affinity, the Cholesky factor and solves, the KNN's selection)."""

GROUPS = ("k1_affinity", "cholesky_solve", "topk_sort")


def read(ctx):
    if ctx["unit"] != "train":
        return None
    g = ctx["profile"]["group_s"]
    total = sum(g.get(name, 0.0) for name in GROUPS)
    return 1e3 * total / ctx["steps"] if total > 0 else None
