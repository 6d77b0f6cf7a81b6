"""op_span_ms.train: device ms a traced step launched in the graph op's
spans (``gl.op.forward`` with ``gl.op.knn``, ``gl.op.affinity`` and
``gl.op.solve``, and ``gl.op.backward``; PGD's op calls too): every kernel
of the op, its matrix products and elementwise passes included, by where
it was launched (common/spans.py)."""
from portbench.common import spans


def read(ctx):
    if ctx["unit"] != "train":
        return None
    t = spans.span_table(ctx)
    names = [n for n in t or {} if n.startswith("gl.op.")]
    if not names:
        return None
    return 1e3 * sum(t[n]["device_s"] for n in names) / ctx["steps"]
