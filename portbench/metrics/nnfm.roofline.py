"""The NNFM kernels' bound over their device time: the least time the
card needs for an epoch's matchings and matched-row losses (the loss
file's ``match_bound_s``, from the configuration's shapes: the larger of
the matching's FLOPs over the peak of the cell's dtype, one product a
FLOP, and the kernels' bytes over 3.35 TB/s), times the images of an
epoch, over ``nnfm.device_ms``. The float32 route runs three TF32 products
a FLOP, so it reads at most about 33%."""

UNIT, SOURCE, MOVES, LAYER = "%", "device_trace", "epoch_ms", "NNFM"


def read(ctx):
    t = ctx.trace
    bound = getattr(ctx.cell.loss, "match_bound_s", None)
    if (t is None or not t.epochs or bound is None
            or not t.device_s_by_layer.get("nnfm")):
        return None
    size = int(ctx.cell.flags["size"])
    per_epoch = t.device_s_by_layer["nnfm"] / t.epochs
    return 100.0 * ctx.work["images_per_epoch"] * bound(
        size, size, ctx.cell.dtype) / per_epoch
