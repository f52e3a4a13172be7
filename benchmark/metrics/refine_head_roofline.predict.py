"""% of its roofline that the refine head (the ``up`` module: the
projection to 16 C and two full-resolution 3x3 convs) reaches in the predict
cell: its least time (``counts.refine_head_ms``) over the device time
launched inside the benchmark's spans around its calls and in the backward
of what they made; mean over ranks."""

from benchmark import counts
from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    if ctx.cell.entry != "predict":
        return None
    a = ctx.arch
    least = counts.refine_head_ms(ctx.cell.batch, a["img_size"], a["patch_size"],
                                  a["embed_dim"], ctx.cell.entry == "train")
    return ctx.layer_share("bench.head", least)
