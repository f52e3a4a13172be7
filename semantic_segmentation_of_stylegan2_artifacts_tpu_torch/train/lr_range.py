"""Learning-rate range test (counterpart of the JAX package's
``train/lr_range.py``; reference ``scripts/csv_handler.py:8-12``,
``trainer.py:303-306, 429-446``): ``n_steps`` train steps with the lr swept
log-uniformly from ``min_lr`` to ``max_lr``, the train loss (and a periodic
validation loss) of each step written to ``lr_range_test.csv``, then the
EWM-smoothed plot.
"""

from __future__ import annotations

import math
import os

from ..metrics.csv_logger import CSVHandler
from .inference import validation_loss


def lr_range_test(
    state,
    train_step,
    batches,
    log_save_path: str,
    min_lr: float = 1e-7,
    max_lr: float = 1e-2,
    n_steps: int = 100,
    eval_step=None,
    val_loader=None,
    val_every: int = 20,
    plot: bool = True,
):
    """Sweep the lr over a stream of ``{"image", "label"}`` batches with
    ``train_step(state, image, label, lr) -> loss`` (the state updated in
    place, :func:`.state.make_train_step`); returns (lrs, losses).

    ``plot`` draws ``weight_decay_test.png`` with matplotlib; where the plot
    cannot be drawn (matplotlib or pandas absent) it is skipped with a
    message, as in the JAX package."""
    os.makedirs(log_save_path, exist_ok=True)
    csv_handler = CSVHandler(log_save_path)
    lrs, losses = [], []
    val_loss = float("nan")
    it = iter(batches)
    ratio = math.log(max_lr / min_lr)
    try:
        for step in range(n_steps):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(batches)
                batch = next(it)
            lr = min_lr * math.exp(ratio * step / max(1, n_steps - 1))
            loss_f = float(train_step(state, batch["image"], batch["label"], lr))
            if eval_step is not None and val_loader is not None and (
                    step % val_every == val_every - 1):
                val_loss = validation_loss(eval_step, val_loader, bool_break=True,
                                           n_batches=5)
            csv_handler.csv_writer.writerow([step, lr, loss_f, val_loss])
            lrs.append(lr)
            losses.append(loss_f)
    finally:
        csv_handler.close_files()
    if plot:
        try:
            from ..viz.plots import plot_lr_range

            plot_lr_range(os.path.join(log_save_path, "lr_range_test.csv"),
                          log_save_path)
        except Exception as e:  # the plot is an extra; the CSV is the result
            print(f"lr_range_test: plot skipped ({type(e).__name__}: {e})")
    return lrs, losses
