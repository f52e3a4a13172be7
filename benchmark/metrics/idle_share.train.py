"""% of the window traced on the device alone in which no device operation but NCCL's ran
(NCCL spins while its rank waits), a train step's; mean over ranks."""

from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    if ctx.cell.entry != "train":
        return None
    return 100.0 * (1.0 - ctx.device_trace.busy_us() / ctx.device_trace.window_us)
