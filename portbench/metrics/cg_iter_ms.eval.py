"""cg_iter_ms.eval: host ms a CG iteration, the ``eval.cg`` spans' host
time over the traced evals' CG iterations (``stable_conjgrad.iterations``
over the window); the matrix-vector product, the vector updates and the
residual's check on the host."""
from portbench.common import spans


def read(ctx):
    if ctx["unit"] != "eval":
        return None
    t = spans.span_table(ctx)
    iters = spans.counter(ctx, "cg_iterations")
    if t is None or "eval.cg" not in t or not iters:
        return None
    return 1e3 * t["eval.cg"]["host_s"] / iters
