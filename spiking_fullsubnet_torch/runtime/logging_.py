"""Logging channels (counterpart of ``spiking_fullsubnet_tpu/runtime/logging_.py``;
reference audiozen/logger.py): python logging and TensorBoard."""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path


class TensorboardLogger:
    """SummaryWriter wrapper (logger.py:10-19). Degrades to a JSONL scalar log
    (``scalars.jsonl`` in ``log_dir``) when ``torch.utils.tensorboard``
    cannot be imported, so training never hard-depends on it."""

    def __init__(self, log_dir: str):
        self._jsonl = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.writer = None
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        else:
            self.writer = SummaryWriter(log_dir=log_dir, max_queue=5, flush_secs=30)

    def add_scalar(self, tag, value, step):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), int(step))
        else:
            self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                          "step": int(step)}) + "\n")
            self._jsonl.flush()

    def add_text(self, tag, text, step=0):
        if self.writer is not None:
            self.writer.add_text(tag, text, int(step))

    def log_config(self, config):
        self.add_text("config", f"```\n{json.dumps(config, indent=2, default=str)}\n```")

    def close(self):
        if self.writer is not None:
            self.writer.close()
        if self._jsonl is not None:
            self._jsonl.close()


def init_logging_logger(config):
    """Root logger with a console and a per-run file handler
    (``<save_dir>/<exp_id>/<exp_id>_<time>.log``; logger.py:22-81)."""
    exp_id = config["meta"].get("exp_id", "exp")
    save_dir = Path(config["meta"]["save_dir"]).expanduser() / exp_id
    save_dir.mkdir(parents=True, exist_ok=True)
    time_now = time.strftime("%Y_%m_%d--%H_%M_%S")
    log_path = save_dir / f"{exp_id}_{time_now}.log"

    root = logging.getLogger()
    root.setLevel(os.environ.get("LOG_LEVEL", "INFO").upper())
    fmt = logging.Formatter("%(asctime)s - %(levelname)s - %(name)s - %(message)s")
    # replace every existing root handler (a basicConfig's would double
    # every line), closing the file handlers of an earlier run
    for h in root.handlers:
        h.close()
    root.handlers = []
    for h in (logging.StreamHandler(), logging.FileHandler(log_path)):
        h.setFormatter(fmt)
        root.addHandler(h)
    return root
