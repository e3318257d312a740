"""One less the device's busy time an epoch (the union of its busy
intervals in the traced half of the window, over its epochs) over the
mean epoch of the untraced half. Traced epochs run longer than untraced
ones by the profiler's host overhead, most where the host sets the pace,
and the device's busy time does not carry that overhead; so the untraced
epoch is the denominator, not the traced window."""

UNIT, SOURCE, MOVES, LAYER = "share", "device_trace", "epoch_ms", "device"


def read(ctx):
    t, es = ctx.trace, ctx.untraced_s
    if t is None or not t.epochs or not t.busy_s or not es:
        return None
    return 1.0 - (t.busy_s / t.epochs) / (sum(es) / len(es))
