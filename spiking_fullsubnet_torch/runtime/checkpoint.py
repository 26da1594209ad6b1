"""Checkpoints: best, latest and rotating epoch directories (counterpart of
``spiking_fullsubnet_tpu/runtime/checkpoint.py``; reference
trainer.py:193-260).

The layout is the JAX package's:
    <exp_dir>/checkpoints/epoch_0042/   (rotating, keep max_num_checkpoints)
    <exp_dir>/checkpoints/best/         (overwritten on score improvement)
Each holds ``trainer_state.json`` and, in place of the JAX package's orbax
``arrays/`` directory, ``arrays.pt``: the training tree (``params``,
``model_state``, ``opt_state``) written by ``torch.save``. Saves are
synchronous. JAX orbax checkpoints are not read.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from .trainer_state import TrainerState

ARRAYS = "arrays.pt"


class CheckpointManager:
    def __init__(self, checkpoints_dir, max_num_checkpoints: int = 10):
        self.dir = Path(checkpoints_dir).expanduser().absolute()
        self.max_num_checkpoints = max_num_checkpoints

    def find_latest(self) -> Path:
        """Latest rotating checkpoint (trainer.py:193-207)."""
        cands = sorted(p for p in self.dir.glob("epoch_" + "[0-9]" * 4) if p.is_dir())
        if not cands:
            raise FileNotFoundError(f"No checkpoints found in {self.dir}")
        return cands[-1]

    def resolve(self, ckpt_path: str) -> Path:
        """``"best"``, ``"latest"`` or a path -> the checkpoint directory."""
        if ckpt_path == "best":
            path = self.dir / "best"
        elif ckpt_path == "latest":
            path = self.find_latest()
        else:
            path = Path(ckpt_path).expanduser().absolute()
        if not path.exists():
            raise FileNotFoundError(f"Checkpoint {path} not found.")
        return path

    def save(self, epoch: int, train_tree: Dict[str, Any], trainer_state: TrainerState,
             is_best_epoch: bool = False) -> Path:
        """Write ``best`` or ``epoch_NNNN``, then keep the newest
        ``max_num_checkpoints`` epoch directories (trainer.py:229-260)."""
        path = self.dir / ("best" if is_best_epoch else f"epoch_{str(epoch).zfill(4)}")
        if path.exists():
            shutil.rmtree(path)
        path.mkdir(parents=True)
        torch.save(train_tree, path / ARRAYS)
        trainer_state.save_json(path / "trainer_state.json")
        checkpoints = sorted(self.dir.glob("epoch_*"))
        for old in checkpoints[: max(0, len(checkpoints) - self.max_num_checkpoints)]:
            shutil.rmtree(old)
        return path

    def load(self, ckpt_path: str, trainer_state: Optional[TrainerState] = None,
             map_location=None) -> Dict[str, Any]:
        """The saved training tree (tensors on ``map_location``), and the
        counters into ``trainer_state`` when given."""
        path = self.resolve(ckpt_path)
        tree = torch.load(path / ARRAYS, map_location=map_location, weights_only=True)
        if trainer_state is not None and (path / "trainer_state.json").exists():
            trainer_state.load_json(path / "trainer_state.json")
        return tree

    def load_weights(self, ckpt_path: str, map_location=None) -> Dict[str, Any]:
        """``params`` and ``model_state`` alone: finetune warm-starts from
        them whatever optimizer wrote the checkpoint."""
        tree = self.load(ckpt_path, map_location=map_location)
        return {"params": tree["params"], "model_state": tree["model_state"]}

    def load_trainer_state(self, ckpt_path: str, trainer_state: TrainerState):
        path = self.resolve(ckpt_path)
        if (path / "trainer_state.json").exists():
            trainer_state.load_json(path / "trainer_state.json")
