"""Run logging: file+console logger and scalar logs (port of
``train/logging_utils.py``).

``setup_logger`` mirrors the reference's (file handler with
asctime-levelname-message, console handler with levelname-message);
``ScalarWriter`` writes the ``Loss/train`` / ``Loss/validation`` tags to a
CSV file always, and to TensorBoard event files when
``torch.utils.tensorboard`` imports.
"""

from __future__ import annotations

import csv
import logging
import os


def setup_logger(log_path: str, name: str = "unet_training_logger") -> logging.Logger:
    os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    logger = logging.getLogger(name)
    if logger.hasHandlers():
        logger.handlers.clear()
    logger.setLevel(logging.INFO)
    fh = logging.FileHandler(log_path)
    fh.setLevel(logging.INFO)
    fh.setFormatter(logging.Formatter("%(asctime)s - %(levelname)s - %(message)s"))
    logger.addHandler(fh)
    ch = logging.StreamHandler()
    ch.setLevel(logging.INFO)
    ch.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
    logger.addHandler(ch)
    return logger


class ScalarWriter:
    """CSV scalar log, plus TensorBoard when its writer imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(log_dir=log_dir)
        except ImportError:
            pass
        self._csv = open(os.path.join(log_dir, "scalars.csv"), "a", newline="")
        self._writer = csv.writer(self._csv)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        self._writer.writerow([tag, step, float(value)])
        self._csv.flush()

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        self._csv.close()
