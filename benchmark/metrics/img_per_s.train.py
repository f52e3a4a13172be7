"""Images a second that the train steps completed over the run's untraced
window, on the host's clock: the steps over the window's seconds, times a
rank's rows; summed over ranks.  The window's pace follows the host the run
lands on, more than the bounds of an end-to-end metric allow, so the train
rate is read here, beside the per-layer readings that explain it."""


def combine(values):
    return sum(values)


def read(ctx):
    if ctx.cell.entry != "train" or ctx.steps_per_s <= 0:
        return None
    return ctx.steps_per_s * ctx.cell.batch
