"""host_syncs.train: the host's waits for the device a traced step, the
program's ``host_syncs`` counter over the traced steps (a step that
waits cannot be captured in a CUDA graph)."""
from portbench.common import spans


def read(ctx):
    if ctx["unit"] != "train":
        return None
    n = spans.counter(ctx, "host_syncs")
    return None if n is None else n / ctx["steps"]
