"""% of its roofline that the window-attention layer (every Swin block's
``attn`` module: qkv, the window products, proj) reaches in the train cell:
its least time from the cell's shapes (the cell's architecture's
``attention_ms``; the MS-UNet's: ``counts.attention_ms``) over the
device time launched inside the benchmark's spans around its calls and in
the backward of what they made; mean over ranks."""

from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    if ctx.cell.entry != "train":
        return None
    return ctx.layer_share("bench.attn", ctx.attention_ms())
