"""Device ms a step of NCCL kernel time that overlaps no other device
operation: the gradient all-reduce's own time and the time a rank spins
waiting for the others; the largest over ranks (the rank that waits most)."""


def combine(values):
    return max(values)


def read(ctx):
    if ctx.cell.entry != "train" or ctx.cell.chips < 2:
        return None
    return ctx.device_trace.nccl_exposed_us() / 1e3 / ctx.steps
