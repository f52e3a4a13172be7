"""% of the card's bf16 peak that the forwards' useful work (the cell's
architecture's ``forward_flops``; the MS-UNet's: the frozen model count)
takes over the run's window: the batches the window completed
over its seconds on the host's clock, before anything is traced."""

from benchmark import counts
from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    if ctx.cell.entry != "predict":
        return None
    return 100.0 * ctx.forward_flops() * ctx.steps_per_s / counts.PEAK_BF16_FLOP_S
