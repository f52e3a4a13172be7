"""% of its roofline that the refine head (the ``up`` module: the
projection to 16 C and two full-resolution 3x3 convs) reaches in the train
cell: its least time (the cell's architecture's ``head_ms``; the MS-UNet's:
``counts.refine_head_ms``) over the device time
launched inside the benchmark's spans around its calls and in the backward
of what they made; mean over ranks."""

from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    if ctx.cell.entry != "train":
        return None
    return ctx.layer_share("bench.head", ctx.head_ms())
