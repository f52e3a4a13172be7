"""% of its roofline that the window-attention layer (every Swin block's
``attn`` module: qkv, the window products, proj) reaches in the predict cell:
its least time from the cell's shapes (``counts.attention_ms``) over the
device time launched inside the benchmark's spans around its calls and in
the backward of what they made; mean over ranks."""

from benchmark import counts
from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    if ctx.cell.entry != "predict":
        return None
    a = ctx.arch
    least = counts.attention_ms(ctx.cell.batch, ctx.window, ctx.cell.entry == "train", **a)
    return ctx.layer_share("bench.attn", least)
