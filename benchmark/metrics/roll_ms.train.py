"""Device ms a train step launched inside the port's ``ssa.roll`` spans (the shift's
pad, rolls and crop) and in the backward of what they made; mean over ranks."""

from benchmark import program
from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    return program.device_ms(ctx, "train", program.ROLL)
