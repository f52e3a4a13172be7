"""Host ms a batch the caller's thread spends inside ``ssa.predict``, less the uploads
then (``ssa.upload``, any thread): what the host takes to issue a batch; mean over
ranks."""

from benchmark import program
from benchmark.metrics import mean as combine  # noqa: F401


def read(ctx):
    return program.host_ms(ctx, "predict")
