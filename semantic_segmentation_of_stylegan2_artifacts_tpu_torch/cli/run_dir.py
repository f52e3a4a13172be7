"""What the CLIs share: the ``log.txt`` logger of a run directory and the
optional TensorBoard writer."""

from __future__ import annotations

import logging
import os


def file_logger(name: str, out_dir: str) -> logging.Logger:
    """A logger writing ``out_dir/log.txt``; close it with :func:`close_logger`."""
    log = logging.getLogger(name)
    log.setLevel(logging.INFO)
    handler = logging.FileHandler(os.path.join(out_dir, "log.txt"))
    handler.setFormatter(logging.Formatter("[%(asctime)s.%(msecs)03d] %(message)s",
                                           datefmt="%H:%M:%S"))
    log.addHandler(handler)
    return log


def close_logger(log: logging.Logger) -> None:
    for handler in log.handlers[:]:
        log.removeHandler(handler)
        handler.close()


def tensorboard_writer(log_dir: str):
    """A TensorBoard ``SummaryWriter`` into ``log_dir``, or None where the
    ``tensorboard`` package is not installed (as in the JAX package's CLIs)."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)
