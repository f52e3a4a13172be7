"""Host ms a train step inside the port's ``ssa.upload`` spans, on any thread: the
copies from pageable host memory, each waiting for the stream to drain; mean
over ranks."""

from benchmark import program
from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    return program.upload_ms(ctx, "train")
