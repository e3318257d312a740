"""The window's mean epoch in the host-bound cells, where host dispatch sets
the pace (the device idles about a third of each epoch), read per layer:
the untraced half of a ``--trace 1`` window, its whole length over its whole
epochs. These epochs swing with the load on the card's host, by more than
half of any bound the contract allows, so the cells keep no end-to-end
epoch and their per-layer metrics move ``peak_mem_mib``."""

UNIT, SOURCE, MOVES = "ms", "host_clock", "peak_mem_mib"
LAYER = "pipelines and dispatch"


def read(ctx):
    if not ctx.untraced_s:
        return None
    return 1e3 * sum(ctx.untraced_s) / len(ctx.untraced_s)
