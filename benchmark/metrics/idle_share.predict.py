"""% of the window traced on the device alone in which no device operation ran, predict batches."""

from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    if ctx.cell.entry != "predict":
        return None
    return 100.0 * (1.0 - ctx.device_trace.busy_us() / ctx.device_trace.window_us)
