"""``torch.cuda.max_memory_allocated()`` over the whole run, read when the
window has closed and before the reference runs: it bounds the styles,
meshes and pixels one card holds."""

UNIT, SOURCE, MOVES, LAYER = "MiB", "host_clock", None, None


def read(ctx):
    return ctx.peak_bytes / 2 ** 20 if ctx.peak_bytes else None
