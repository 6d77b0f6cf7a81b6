"""encoder_span_ms.train: device ms a traced step launched in the
encoder's spans, ``gl.encode`` (forward) and ``gl.backward`` (the
backward, less the op's own ``gl.op.backward`` inside it), PGD's input
gradients included (common/spans.py)."""
from portbench.common import spans

NAMES = ("gl.encode", "gl.backward")


def read(ctx):
    if ctx["unit"] != "train":
        return None
    t = spans.span_table(ctx)
    if t is None or not all(n in t for n in NAMES):
        return None
    return 1e3 * sum(t[n]["device_s"] for n in NAMES) / ctx["steps"]
