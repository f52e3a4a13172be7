"""Device ms a step of the operations launched inside PyTorch's own
``Optimizer.step#AdamW.step`` range (the update of ``train/optim.py``'s
AdamW); mean over ranks."""

from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    if ctx.cell.entry != "train":
        return None
    us = ctx.trace.span_device_us("Optimizer.step#")
    return us / 1e3 / ctx.steps if us else None
