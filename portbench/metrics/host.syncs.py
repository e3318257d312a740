"""Host synchronisations (device, stream and event syncs, blocking copies)
that start in the traced window, per epoch, less the harness's own one at
each epoch end."""

UNIT, SOURCE, MOVES = "syncs/epoch", "device_trace", "epoch_ms"
LAYER = "pipelines and dispatch"


def read(ctx):
    t = ctx.trace
    if t is None or not t.epochs or not t.syncs:
        return None
    return (t.syncs - t.epochs) / t.epochs
