"""% of the card's bf16 peak that the train steps' useful work (the frozen
model count: forward, backward twice, AdamW; recomputation not counted)
takes over the run's window: the steps the window completed over its
seconds on the host's clock, before anything is traced; mean over ranks,
each counting its own rows."""

from benchmark import counts
from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    if ctx.cell.entry != "train":
        return None
    a = ctx.arch
    flops = counts.train_step_flops(a["img_size"], ctx.cell.batch, ctx.params,
                                    patch_size=a["patch_size"], embed_dim=a["embed_dim"],
                                    depths=a["depths"], window_size=ctx.window)
    return 100.0 * flops * ctx.steps_per_s / counts.PEAK_BF16_FLOP_S
