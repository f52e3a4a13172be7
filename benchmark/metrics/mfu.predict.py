"""% of the card's bf16 peak that the forwards' useful work (the frozen
model count) takes over the run's window: the batches the window completed
over its seconds on the host's clock, before anything is traced."""

from benchmark import counts
from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    if ctx.cell.entry != "predict":
        return None
    a = ctx.arch
    flops = counts.forward_flops(a["img_size"], ctx.cell.batch, patch_size=a["patch_size"],
                                 embed_dim=a["embed_dim"], depths=a["depths"],
                                 window_size=ctx.window)
    return 100.0 * flops * ctx.steps_per_s / counts.PEAK_BF16_FLOP_S
