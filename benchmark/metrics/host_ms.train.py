"""Host ms a train step the step's thread spends inside ``ssa.step``, less the uploads
then (``ssa.upload``, any thread): what the host takes to issue a train step; mean over
ranks."""

from benchmark import program
from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    return program.host_ms(ctx, "train")
