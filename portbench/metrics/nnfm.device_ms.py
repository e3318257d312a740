"""Device time per epoch of the kernels that ``layers/nnfm.json`` matches:
every kernel of ARF's nearest-neighbour feature matching (``nnfm_*``: the
conv3 block's centring and normalisation, the matching, the matched-row
loss and its backward). Cells of a configuration whose loss is not NNFM
run none, and read nothing."""

UNIT, SOURCE, MOVES, LAYER = "ms/epoch", "device_trace", "epoch_ms", "NNFM"


def read(ctx):
    t = ctx.trace
    if t is None or not t.epochs or not t.device_s_by_layer.get("nnfm"):
        return None
    return 1e3 * t.device_s_by_layer["nnfm"] / t.epochs
