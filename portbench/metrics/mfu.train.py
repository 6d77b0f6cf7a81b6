"""mfu.train: the train step's least seconds at the H100's dense TF32 peak
(495 TFLOP/s; its model FLOPs from common/counts.py and the encoder's
layers) times the traced steps, over the traced window's host seconds."""


def read(ctx):
    if ctx["unit"] != "train":
        return None
    return 100.0 * ctx["ideal_s"] * ctx["steps"] / ctx["profile"]["window_s"]
