"""Trainer bookkeeping state (a copy of
``spiking_fullsubnet_tpu/runtime/trainer_state.py``; reference
audiozen/trainer_utils.py:28-54)."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class TrainerState:
    def __init__(self, save_max_score: bool = True) -> None:
        self.epochs_trained = 0
        self.steps_trained = 0
        self.patience = 0
        self.best_score = -np.inf if save_max_score else np.inf
        self.best_score_epoch = 0

    def state_dict(self) -> dict:
        return {
            "epochs_trained": self.epochs_trained,
            "steps_trained": self.steps_trained,
            "patience": self.patience,
            "best_score": float(self.best_score),
            "best_score_epoch": self.best_score_epoch,
        }

    def load_state_dict(self, state_dict: dict) -> None:
        self.epochs_trained = state_dict["epochs_trained"]
        self.steps_trained = state_dict["steps_trained"]
        self.patience = state_dict["patience"]
        self.best_score = state_dict["best_score"]
        self.best_score_epoch = state_dict["best_score_epoch"]

    def save_json(self, path) -> None:
        Path(path).write_text(json.dumps(self.state_dict()))

    def load_json(self, path) -> None:
        self.load_state_dict(json.loads(Path(path).read_text()))
