"""Kernel launches per epoch in the traced window: the kernels the device
ran there, one launch each (CUPTI records a runtime launch and the driver
call under it, so counting the calls would count most launches twice).
An exact count that dispatch work (fusion, graphs) lowers."""

UNIT, SOURCE, MOVES = "launches/epoch", "device_trace", "epoch_ms"
LAYER = "pipelines and dispatch"


def read(ctx):
    t = ctx.trace
    if t is None or not t.epochs or not t.kernels:
        return None
    return t.kernels / t.epochs
