"""The VGG work's bound over its device time: the least time the card
needs for an epoch's VGG steps (``work.vgg_bound_s``, from the
configuration's shapes, each layer the larger of FLOPs over the peak of
the cell's dtype and bytes over 3.35 TB/s) over ``vgg.device_ms``."""

UNIT, SOURCE, MOVES, LAYER = "%", "device_trace", "epoch_ms", "VGG-19"


def read(ctx):
    t = ctx.trace
    if t is None or not t.epochs or not t.device_s_by_layer.get("vgg"):
        return None
    per_epoch = t.device_s_by_layer["vgg"] / t.epochs
    return 100.0 * ctx.work["vgg_bound_s_per_epoch"] / per_epoch
