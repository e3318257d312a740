"""The window's mean epoch: its whole length over its whole epochs. An
epoch is one pass of the port's loop over every view batch (and every
style), the unit users count (``--epochs 3000``)."""

UNIT, SOURCE, MOVES, LAYER = "ms", "host_clock", None, None


def read(ctx):
    if not ctx.epoch_s:
        return None
    return 1e3 * ctx.window_s / len(ctx.epoch_s)
