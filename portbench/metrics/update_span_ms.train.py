"""update_span_ms.train: device ms a traced step launched in
``gl.update`` and no span inside it: zeroing the gradients, the
optimizer's and the scheduler's steps, the step's metrics and its finite
check (common/spans.py)."""
from portbench.common import spans


def read(ctx):
    if ctx["unit"] != "train":
        return None
    t = spans.span_table(ctx)
    if t is None or "gl.update" not in t:
        return None
    return 1e3 * t["gl.update"]["device_s"] / ctx["steps"]
