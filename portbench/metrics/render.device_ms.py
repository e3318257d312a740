"""Device time per epoch of the kernels that ``layers/render.json``
matches: the raster kernels, the texture gather and its scatter, the
index-put backward and the sorts."""

UNIT, SOURCE, MOVES, LAYER = "ms/epoch", "device_trace", "epoch_ms", "render"


def read(ctx):
    t = ctx.trace
    if t is None or not t.epochs or not t.device_s_by_layer.get("render"):
        return None
    return 1e3 * t.device_s_by_layer["render"] / t.epochs
