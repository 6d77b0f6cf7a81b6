"""mfu.eval: an eval's least seconds at the H100's peaks (the encoder's
forward at the dense TF32 peak, 495 TFLOP/s; the exact KNN's one triangle
at the float32 peak, 67 TFLOP/s) times the traced evals, over the traced
window's host seconds."""


def read(ctx):
    if ctx["unit"] != "eval":
        return None
    return 100.0 * ctx["ideal_s"] * ctx["steps"] / ctx["profile"]["window_s"]
