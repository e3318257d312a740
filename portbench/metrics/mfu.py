"""Model FLOPs over the untraced part of the window times the card's peak:
VGG-19's forward to conv5_1, its input-gradient backward and the five
style Grams with their backward (``work.epoch_flops``, 893.1 GFLOP an image
at 768²) an epoch, over the mean epoch of the window's first half, which
the traced run times before its profiler starts (so the profiler's host
overhead does not stretch it), against 989 TFLOP/s in bf16 cells and 495
TFLOP/s (TF32, the units the float32 route's 3xTF32 runs on) in float32
cells."""

UNIT, SOURCE, MOVES, LAYER = "%", "host_clock", "epoch_ms", "device"


def read(ctx):
    es = ctx.untraced_s
    if not es:
        return None
    flops = ctx.work["epoch_flops"] * len(es)
    return 100.0 * flops / (sum(es) * ctx.work["peak_flops"])
