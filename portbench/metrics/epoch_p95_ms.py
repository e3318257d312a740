"""The 95th percentile of all the window's epochs, each from one epoch-end
synchronisation to the next (``statistics.quantiles``, inclusive)."""

import statistics

UNIT, SOURCE, MOVES, LAYER = "ms", "host_clock", None, None


def read(ctx):
    if len(ctx.epoch_s) < 2:
        return None
    return 1e3 * statistics.quantiles(ctx.epoch_s, n=100,
                                      method="inclusive")[94]
