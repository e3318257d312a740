"""Device time per epoch of the kernels that ``layers/vgg.json`` matches:
the convs, Grams, stage-1 kernels and pools of VGG-19, forward and
backward."""

UNIT, SOURCE, MOVES, LAYER = "ms/epoch", "device_trace", "epoch_ms", "VGG-19"


def read(ctx):
    t = ctx.trace
    if t is None or not t.epochs or not t.device_s_by_layer.get("vgg"):
        return None
    return 1e3 * t.device_s_by_layer["vgg"] / t.epochs
