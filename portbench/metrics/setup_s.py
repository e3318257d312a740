"""Set-up: from the process's start to the window's opening. Imports, the
CUDA context, the kernel libraries (built into ``build/st3d_torch/`` on a
checkout's first run, loaded after), the inputs drawn from the seed, the
scene, the VGG weights, the style and content targets, the hoisted
visibility and the warm-up epochs."""

UNIT, SOURCE, MOVES, LAYER = "s", "host_clock", None, None


def read(ctx):
    return ctx.setup_s
