"""CSV logging with the reference's 7-file schema (counterpart of the JAX
package's ``metrics/csv_logger.py``; reference ``scripts/csv_handler.py``):
the same file names, headers and column orders, the ``FRP`` and
``" val_loss"`` spellings included.  The grid-search driver ranks runs on
``val_metric_all_epoch.csv``'s ``Score`` column (reference ``run.py:29-31``).
"""

from __future__ import annotations

import csv
import os

from .segmentation import EpochSummary

HEADERS = {
    "lr_range_test.csv": ["step", "lr", "train_loss", "val_loss"],
    "batch_test_file.csv": ["epoch", "case_name"],
    "val_metric_all_epoch.csv": [
        "epoch", "mean_accuracy", "mean_val_loss", "mean_train_loss",
        "mean_confusion_matrix_bin", "mean_confusion_matrix_soft", "Score"],
    "val_metric_real_epoch.csv": [
        "epoch", "accuracy_real", "mean_confusion_matrix_bin",
        "mean_confusion_matrix_soft", "mean_val_loss_real", "FRP"],
    "val_metric_fake_epoch.csv": [
        "epoch", "mean_accuracy", "mean_val_loss_fake", "mean_confusion_matrix_bin",
        "mean_confusion_matrix_soft", "mean_bin_accuracy", "mean_bin_recall",
        "mean_bin_precision", "mean_bin_IoU", "mean_bin_dice", "mean_bin_f1",
        "mean_i_soft_dice", "mean_i_soft_iou"],
    "val_metric_real_batch.csv": [
        "epoch", "batch", "accuracy", "confusion_matrix_bin", " val_loss"],
    "val_metric_fake_batch.csv": [
        "epoch", "batch", "bin_accuracy", "bin_recall", "bin_precision", "val_loss",
        "bin_IoU", "bin_dice", "bin_f1", "confusion_matrix_bin",
        "confusion_matrix_soft", "i_soft_dice", "i_soft_iou"],
}


class CSVHandler:
    """Opens the 7 CSV files with their headers and writes the epoch rows
    (a context manager; :meth:`close_files` closes them)."""

    def __init__(self, log_save_path: str):
        os.makedirs(log_save_path, exist_ok=True)
        self._files = []
        writers = {}
        for name, header in HEADERS.items():
            f = open(os.path.join(log_save_path, name), "w", newline="")
            self._files.append(f)
            writers[name] = csv.writer(f)
            writers[name].writerow(header)
        self.csv_writer = writers["lr_range_test.csv"]
        self.csv_writer_batch = writers["batch_test_file.csv"]
        self.csv_all_epoch = writers["val_metric_all_epoch.csv"]
        self.csv_real_epoch = writers["val_metric_real_epoch.csv"]
        self.csv_fake_epoch = writers["val_metric_fake_epoch.csv"]
        self.csv_batch_real = writers["val_metric_real_batch.csv"]
        self.csv_batch_fake = writers["val_metric_fake_batch.csv"]

    def write_epoch(self, s: EpochSummary) -> None:
        """One row each in the real, fake and all-epoch files
        (columns per ``validation_functions.py``), then flush."""
        if s.n_real > 0:
            self.csv_real_epoch.writerow([
                s.epoch, s.mean_accuracy_real, s.mean_conf_bin_real,
                s.mean_conf_soft_real, s.mean_val_loss_real, s.mean_fpr])
        self.csv_fake_epoch.writerow([
            s.epoch, s.mean_accuracy_fake, s.mean_val_loss_fake,
            s.mean_conf_bin_fake, s.mean_conf_soft_fake,
            s.mean_bin_accuracy, s.mean_bin_recall, s.mean_bin_precision,
            s.mean_bin_iou, s.mean_bin_dice, s.mean_bin_f1,
            s.mean_soft_dice, s.mean_soft_iou])
        self.csv_all_epoch.writerow([
            s.epoch, s.mean_accuracy, s.mean_val_loss, s.mean_train_loss,
            s.mean_conf_bin, s.mean_conf_soft, s.score])
        self.flush()

    def flush(self) -> None:
        for f in self._files:
            f.flush()

    def close_files(self) -> None:
        for f in self._files:
            if not f.closed:
                f.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close_files()
