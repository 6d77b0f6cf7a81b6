"""host_syncs.eval: the host's waits for the device a traced eval, the
program's ``host_syncs`` counter over the traced evals: CG's check of
every iteration, the BSR plan's reads, the harness's sync and its read of
the predictions."""
from portbench.common import spans


def read(ctx):
    if ctx["unit"] != "eval":
        return None
    n = spans.counter(ctx, "host_syncs")
    return None if n is None else n / ctx["steps"]
