"""Leveled logger, the CSV metrics sink and the JSONL eval sink (port of
mobilefinetuner_tpu/core/logging.py): the same log format, CSV columns
and eval records as the JAX package's CLIs, so tools that read one read
the other.
"""

from __future__ import annotations

import csv
import json
import logging
import os
import sys
import time


def get_logger(name: str = "mft", level: str = "INFO") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] %(message)s",
            "%Y-%m-%d %H:%M:%S"))
        logger.addHandler(sh)
    logger.propagate = False
    return logger


class MetricsLogger:
    """CSV training metrics, one row per logged step. A file whose header
    differs from COLUMNS is rotated to `.old` rather than appended to."""

    COLUMNS = ["timestamp", "epoch", "step", "loss", "avg_loss", "lr",
               "grad_norm", "step_time_ms", "host_wait_ms", "tok_s",
               "mfu", "hbm_mb"]

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if os.path.exists(path):
            with open(path, newline="") as f:
                header = f.readline().strip().split(",")
            if header != self.COLUMNS:
                os.replace(path, path + ".old")
        new = not os.path.exists(path)
        self._f = open(path, "a", newline="")
        self._w = csv.writer(self._f)
        if new:
            self._w.writerow(self.COLUMNS)
            self._f.flush()

    def log(self, epoch: int, step: int, loss: float, avg_loss: float,
            lr: float, step_time_ms: float, host_wait_ms: float = 0.0,
            hbm_mb: float = 0.0, grad_norm: float = 0.0,
            tok_s: float = 0.0, mfu=None):
        self._w.writerow([f"{time.time():.3f}", epoch, step, f"{loss:.6f}",
                          f"{avg_loss:.6f}", f"{lr:.8f}",
                          f"{grad_norm:.4f}", f"{step_time_ms:.2f}",
                          f"{host_wait_ms:.2f}", f"{tok_s:.1f}",
                          "" if mfu is None else f"{mfu:.4f}",
                          f"{hbm_mb:.1f}"])
        self._f.flush()

    def close(self):
        self._f.close()


class JSONLWriter:
    """Append-only JSONL sink for eval records."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def write(self, record: dict):
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
