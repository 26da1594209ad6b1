"""Trainer runtime for one process: the epoch loop, validation, test,
predict, finetune and checkpoints (counterpart of
``spiking_fullsubnet_tpu/runtime/trainer.py``; reference
audiozen/trainer.py:29-828).

Behaviour kept from the JAX trainer:
- max_steps/max_epochs control flow (``max_steps`` stops at exactly that
  many updates, mid-epoch if need be), gradient accumulation (the summed
  gradients divided by the step count before the clip and the update),
  clipping by global norm with the norm logged before the clip, the
  learning rate of update n from the warm-up schedule at n, periodic
  validation, early stopping by patience, best and rotating checkpoints,
  resume from ``latest``, the loader's per-epoch shuffle;
- the exp-dir layout ``save_dir/exp_id/{checkpoints,tb_log,enhanced,
  metrics}``, the config snapshot, TensorBoard scalars (per-update norm and
  learning rate, per-epoch losses);
- the BN running statistics carried from step to step.

The recipe's ``training_step(noisy, clean)`` runs the forward, the loss
and its backward (adding into ``.grad``) and returns (loss dict, new model
state); the base trainer makes the optimizer update. Weights, model state
and batches live on ``device`` (``cuda`` unless the caller passes
``"cpu"``).
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .checkpoint import CheckpointManager
from .config import toml_dump
from .convert import flat_paths
from .debug import detect_overflow, enable_debug_nans
from .device import resolve_device
from .logging_ import TensorboardLogger
from .optimization import create_warmup_schedule, get_warmup_steps
from .trainer_state import TrainerState

logger = logging.getLogger(__name__)


def tensors_of(tree) -> List[torch.Tensor]:
    """The tensor leaves of a nested dict/list tree, in its order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors_of(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors_of(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def optimizer_update(optimizer: torch.optim.Optimizer, max_grad_norm: Optional[float],
                     lr: Optional[float] = None, accum_steps: int = 1) -> torch.Tensor:
    """One update from the gradients in ``.grad``: divided by
    ``accum_steps`` (``trainer.py:279-281``), their global norm taken,
    clipped to ``max_grad_norm`` (``trainer.py:181-182``; not clipped when
    it is 0 or None), every group's learning rate set to ``lr`` (when
    given), then ``optimizer.step()``. Returns the global norm before
    clipping. torch's ``clip_grad_norm_`` divides by the norm plus 1e-6,
    optax's ``clip_by_global_norm`` by the norm alone."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    if accum_steps > 1:
        for p in params:
            if p.grad is not None:
                p.grad.div_(accum_steps)
    grad_norm = torch.nn.utils.clip_grad_norm_(params, max_grad_norm or float("inf"))
    if lr is not None:
        for group in optimizer.param_groups:
            group["lr"] = lr
    optimizer.step()
    return grad_norm


class Trainer:
    def __init__(
        self,
        config: Dict[str, Any],
        resume: bool,
        model: Dict[str, Any],
        optimizer_factory,
        base_lr: float,
        loss_function=None,
        device=None,
    ):
        """
        Args:
            config: the experiment TOML dict (meta, trainer, acoustics).
            resume: resume from the latest checkpoint.
            model: bundle with "config", "apply" (``apply(cfg, params,
                state, noisy, train)``), "params" and "state" (the BN
                running statistics), tensors on ``device``.
            optimizer_factory: params -> torch optimizer
                (``registry.build_optimizer_factory``).
            base_lr: learning rate before schedule shaping.
            loss_function: optional callable passed through to recipes.
            device: where the weights are and where batches go.
        """
        self.config = config
        self.resume = resume
        self.device = resolve_device(device)
        self._initialize_exp_dirs_and_paths(config)

        self.model = model
        self.params = model["params"]
        self.model_state = model["state"]
        self.model_apply = model["apply"]
        self.model_config = model.get("config")
        self.optimizer_factory = optimizer_factory
        self.base_lr = base_lr
        self.loss_function = loss_function
        self.weights = [p.requires_grad_(True) for p in tensors_of(self.params)]
        self._ckpt_preloaded = False  # weights imported by preload_weights

        acoustics = config.get("acoustics", {})
        self.sr = acoustics.get("sr", 16000)

        # Trainer args (reference trainer.py:60-74)
        trainer_config = config["trainer"]["args"]
        self.trainer_config = trainer_config
        self.debug = trainer_config.get("debug", False)
        self.max_steps = trainer_config.get("max_steps", 0)
        self.max_epochs = trainer_config.get("max_epochs", sys.maxsize)
        self.max_grad_norm = trainer_config.get("max_grad_norm", 0)
        self.save_max_score = trainer_config.get("save_max_score", True)
        self.save_ckpt_interval = trainer_config.get("save_ckpt_interval", 1)
        self.max_patience = trainer_config.get("max_patience", 10)
        self.plot_norm = trainer_config.get("plot_norm", True)
        self.plot_lr = trainer_config.get("plot_lr", False)
        self.validation_interval = trainer_config.get("validation_interval", 1)
        self.max_num_checkpoints = trainer_config.get("max_num_checkpoints", 10)
        self.scheduler_name = trainer_config.get("scheduler_name",
                                                 "constant_schedule_with_warmup")
        self.warmup_steps = trainer_config.get("warmup_steps", 0)
        self.warmup_ratio = trainer_config.get("warmup_ratio", 0.0)
        self.gradient_accumulation_steps = trainer_config.get("gradient_accumulation_steps", 1)

        self.state = TrainerState(save_max_score=self.save_max_score)
        self.ckpt_manager = CheckpointManager(self.checkpoints_dir, self.max_num_checkpoints)
        for d in [self.exp_dir, self.checkpoints_dir, self.tb_log_dir, self.enhanced_dir,
                  self.metrics_dir]:
            Path(d).mkdir(parents=True, exist_ok=True)

        self.writer = TensorboardLogger(str(self.tb_log_dir))
        self.writer.log_config(config)
        try:
            toml_dump(config, self.config_path)
        except TypeError:
            pass  # configs with exotic values skip the snapshot rather than crash

        if self.debug:
            enable_debug_nans(True)

        self.optimizer = optimizer_factory(self.weights)
        self.lr_schedule = None  # set in train() (the warm-up needs max_steps)
        logger.info(f"Model parameters: {sum(p.numel() for p in self.weights):,}")

    # ------------------------------------------------------------------ setup

    @staticmethod
    def _get_time_now():
        return time.strftime("%Y_%m_%d--%H_%M_%S")

    def _initialize_exp_dirs_and_paths(self, config):
        """Exp-dir layout (reference trainer.py:163-191)."""
        self.save_dir = Path(config["meta"]["save_dir"]).expanduser().absolute()
        self.exp_dir = self.save_dir / config["meta"]["exp_id"]
        self.checkpoints_dir = self.exp_dir / "checkpoints"
        self.tb_log_dir = self.exp_dir / "tb_log"
        self.enhanced_dir = self.exp_dir / "enhanced"
        self.metrics_dir = self.exp_dir / "metrics"
        self.config_path = self.exp_dir / f"config__{self._get_time_now()}.toml"

    def to_device(self, array) -> torch.Tensor:
        return torch.from_numpy(np.asarray(array)).to(self.device)

    # ------------------------------------------------------------------ recipe contract

    def training_step(self, noisy: torch.Tensor, clean: torch.Tensor):
        """Forward, loss and backward of one batch (gradients added into
        ``.grad``) -> (loss dict, new model state). Implement in the recipe."""
        raise NotImplementedError

    def validation_step(self, batch, batch_idx, dataloader_idx=0):
        raise NotImplementedError

    def validation_epoch_end(self, validation_epoch_output):
        raise NotImplementedError

    def test_step(self, batch, batch_idx, dataloader_idx=0):
        raise NotImplementedError

    def test_epoch_end(self, test_epoch_output):
        raise NotImplementedError

    def predict_step(self, batch, batch_idx, dataloader_idx=0):
        pass

    def training_epoch_end(self, training_epoch_output):
        """Mean losses -> TB (reference trainer.py:650-686)."""
        if not training_epoch_output:
            return
        for key in training_epoch_output[0]:
            loss_mean = float(np.mean([step_out[key] for step_out in training_epoch_output]))
            logger.info(f"Loss '{key}' on epoch {self.state.epochs_trained}: {loss_mean}")
            self.writer.add_scalar(f"Train_Epoch/{key}", loss_mean, self.state.epochs_trained)

    # ------------------------------------------------------------------ checkpointing

    def _train_tree(self) -> Dict[str, Any]:
        """What a checkpoint holds: weights, model state, optimizer state."""
        return {"params": self.params, "model_state": self.model_state,
                "opt_state": self.optimizer.state_dict()}

    def _save_checkpoint(self, epoch: int, is_best_epoch: bool):
        self.ckpt_manager.save(epoch, self._train_tree(), self.state, is_best_epoch)

    def _set_weights(self, tree):
        """Copy saved weights into the live ones (the optimizer holds them)
        and take the saved model state."""
        saved = tensors_of(tree["params"])
        if [s.shape for s in saved] != [w.shape for w in self.weights]:
            raise ValueError("checkpoint weights do not match the model's")
        with torch.no_grad():
            for w, s in zip(self.weights, saved):
                w.copy_(s)
        self.model_state = tree["model_state"]

    def preload_weights(self, params, model_state):
        """Take imported weights (``--torch_ckpt``): copied into the live
        weights by path, the model state taken. Test, predict and finetune
        then evaluate them where the experiment has no checkpoint."""
        live, new = flat_paths(self.params), flat_paths(params)
        if live.keys() != new.keys():
            raise ValueError(f"imported weights: keys {sorted(new.keys() ^ live.keys())} are "
                             "not in both the import and the model")
        with torch.no_grad():
            for k, w in live.items():
                if w.shape != new[k].shape:
                    raise ValueError(f"imported weights at {k}: {tuple(new[k].shape)}, the "
                                     f"model's {tuple(w.shape)}")
                w.copy_(new[k])
        self.model_state = model_state
        self._ckpt_preloaded = True

    def _restore(self, tree: Dict[str, Any]):
        """Take a loaded ``_train_tree``."""
        self._set_weights(tree)
        self.optimizer.load_state_dict(tree["opt_state"])

    def _load_checkpoint(self, ckpt_path: str):
        self._restore(self.ckpt_manager.load(ckpt_path, self.state, map_location=self.device))
        logger.info(f"Checkpoint on epoch {self.state.epochs_trained} is loaded.")

    def _load_eval_weights(self, ckpt_path: str):
        """Weights for test/predict; ``ckpt_path='init'`` evaluates the
        freshly initialized weights (smoke runs, e2e tests)."""
        if ckpt_path == "init":
            logger.warning("ckpt_path='init': evaluating UNTRAINED weights.")
            return
        if self._ckpt_preloaded:
            try:
                self.ckpt_manager.resolve(ckpt_path)
            except FileNotFoundError:
                logger.info("Using pre-imported torch checkpoint weights for evaluation.")
                return
        self._load_checkpoint(ckpt_path)

    def _check_improvement(self, score, save_max_score=True):
        return score > self.state.best_score if save_max_score else score < self.state.best_score

    def _run_early_stop_check(self, score: float) -> bool:
        """(reference trainer.py:119-139)"""
        if self._check_improvement(score, self.save_max_score):
            self.state.best_score = score
            self.state.best_score_epoch = self.state.epochs_trained
            self._save_checkpoint(self.state.epochs_trained, is_best_epoch=True)
            self.state.patience = 0
            logger.info(f"Found new best score: {score:.4f}, saving checkpoint...")
            return False
        self.state.patience += 1
        logger.info(
            f"Score did not improve from {self.state.best_score:.4f} at epoch "
            f"{self.state.best_score_epoch}. Early stopping counter: "
            f"{self.state.patience} out of {self.max_patience}"
        )
        return self.state.patience >= self.max_patience

    # ------------------------------------------------------------------ train

    def train(self, train_dataloader, validation_dataloaders):
        """Epoch loop (reference trainer.py:327-468)."""
        accum = self.gradient_accumulation_steps
        steps_per_epoch = len(train_dataloader)
        update_steps_per_epoch = max(steps_per_epoch // accum, 1)
        if self.max_steps > 0:
            max_steps = self.max_steps
            max_epochs = -(-self.max_steps // update_steps_per_epoch)
        else:
            max_steps = self.max_epochs * update_steps_per_epoch
            max_epochs = self.max_epochs
        logger.info(
            f"Training control variables: steps_per_epoch={steps_per_epoch}, "
            f"grad_accum={accum}, update_steps_per_epoch={update_steps_per_epoch}, "
            f"max_steps={max_steps}, max_epochs={max_epochs}"
        )

        self._build_schedules(max_steps, update_steps_per_epoch)
        if self.resume:
            self._load_checkpoint("latest")

        updates_done = self.state.steps_trained // accum
        steps_exhausted = False
        self.optimizer.zero_grad(set_to_none=True)
        for epoch in range(self.state.epochs_trained + 1, max_epochs + 1):
            logger.info(f"{'=' * 9} Epoch {epoch} out of {max_epochs} {'=' * 9}")
            epoch_t0 = time.time()
            training_epoch_output = []
            self._micro = 0  # as the JAX trainer: a partial sum carries into the next epoch
            for batch in train_dataloader:
                loss_dict, update = self._train_batch(batch, updates_done)
                if update is not None:
                    updates_done += 1
                    self._log_step(*update)
                training_epoch_output.append({k: float(v) for k, v in loss_dict.items()})
                self.state.steps_trained += 1
                if (self.max_steps > 0 and updates_done >= self.max_steps
                        and not self.whole_epochs):
                    steps_exhausted = True
                    logger.info(f"Reached max_steps={self.max_steps}, stopping training.")
                    break

            self.state.epochs_trained += 1
            self.training_epoch_end(training_epoch_output)
            logger.info(f"Epoch {epoch} took {time.time() - epoch_t0:.1f}s")

            if self.debug:
                detect_overflow(self.params, tag=f"epoch{epoch}/params")

            if epoch % self.save_ckpt_interval == 0:
                self._save_checkpoint(epoch, is_best_epoch=False)

            early_stop = False
            if epoch % self.validation_interval == 0:
                logger.info("Training finished, begin validation...")
                early_stop = self._run_early_stop_check(self.validate(validation_dataloaders))
                logger.info("Validation finished.")

            if hasattr(train_dataloader, "set_epoch"):
                train_dataloader.set_epoch(epoch)
            if early_stop:
                logger.info("Early stopping triggered, stopping training...")
                break
            if steps_exhausted:
                break

    #: ``max_steps`` rounds up to whole epochs instead of stopping mid-epoch
    whole_epochs = False

    def _train_batch(self, batch, n: int):
        """One batch at update count ``n``: ``training_step`` adds its
        gradients, and the batch that completes ``gradient_accumulation_steps``
        makes the update at the schedule's rate for ``n``. Returns (loss
        dict, (global norm before clipping, rate) or None without an
        update)."""
        loss_dict, state = self.training_step(self.to_device(batch[0]), self.to_device(batch[1]))
        self.model_state = state
        self._micro += 1
        if self._micro < self.gradient_accumulation_steps:
            return loss_dict, None
        self._micro = 0
        lr = self.lr_schedule(n)
        return loss_dict, (self.optimizer_update(lr), lr)

    def _build_schedules(self, max_steps: int, steps_per_epoch: int):
        """``self.lr_schedule``, the learning rate of each update: the
        warm-up schedule."""
        num_warmup = get_warmup_steps(self.warmup_steps, max_steps, self.warmup_ratio)
        self.lr_schedule = create_warmup_schedule(self.scheduler_name, self.base_lr, max_steps,
                                                  num_warmup)

    def optimizer_update(self, lr: float) -> torch.Tensor:
        """One optimizer update at learning rate ``lr`` from the summed
        gradients; returns their global norm before clipping."""
        grad_norm = optimizer_update(self.optimizer, self.max_grad_norm, lr,
                                     self.gradient_accumulation_steps)
        self.optimizer.zero_grad(set_to_none=True)
        return grad_norm

    def finetune(self, train_dataloader, validation_dataloaders, ckpt_path="best"):
        """Warm-start the weights from a checkpoint, then train with a fresh
        optimizer, schedule and counters (the reference CLI's ``-M
        finetune``, run.py:121). Finetune checkpoints go to
        ``checkpoints_finetune/``, so the warm-start checkpoint and the base
        run's ``best`` are never overwritten."""
        try:
            self._set_weights(self.ckpt_manager.load_weights(ckpt_path,
                                                             map_location=self.device))
            logger.info(f"Finetune: warm-started weights from '{ckpt_path}'.")
        except FileNotFoundError:
            if not self._ckpt_preloaded:
                raise
            logger.info("Finetune: using pre-imported torch checkpoint weights.")
        self.state = TrainerState(save_max_score=self.save_max_score)
        self.optimizer = self.optimizer_factory(self.weights)
        self.resume = False
        self.ckpt_manager = CheckpointManager(self.checkpoints_dir.parent / "checkpoints_finetune",
                                              self.max_num_checkpoints)
        self.train(train_dataloader, validation_dataloaders)

    def _log_step(self, grad_norm: torch.Tensor, lr: float):
        """Per-update scalars: the global norm before clipping and the
        learning rate the update used."""
        if self.plot_norm:
            self.writer.add_scalar("Train_Step/norm", float(grad_norm), self.state.steps_trained)
        if self.plot_lr:
            self.writer.add_scalar("Train_Step/lr", lr, self.state.steps_trained)

    # ------------------------------------------------------------------ eval

    def validate(self, dataloaders):
        """(reference trainer.py:470-523)"""
        if not isinstance(dataloaders, list):
            dataloaders = [dataloaders]
        outputs = [[self.validation_step(batch, batch_idx, dataloader_idx)
                    for batch_idx, batch in enumerate(dataloader)]
                   for dataloader_idx, dataloader in enumerate(dataloaders)]
        return self.validation_epoch_end(outputs)

    def test(self, dataloaders, ckpt_path="best"):
        """(reference trainer.py:525-563)"""
        if not isinstance(dataloaders, list):
            dataloaders = [dataloaders]
        self._load_eval_weights(ckpt_path)
        outputs = [[self.test_step(batch, batch_idx, dataloader_idx)
                    for batch_idx, batch in enumerate(dataloader)]
                   for dataloader_idx, dataloader in enumerate(dataloaders)]
        return self.test_epoch_end(outputs)

    def predict(self, dataloaders, ckpt_path="best"):
        """(reference trainer.py:565-595)"""
        if not isinstance(dataloaders, list):
            dataloaders = [dataloaders]
        self._load_eval_weights(ckpt_path)
        for dataloader_idx, dataloader in enumerate(dataloaders):
            for batch_idx, batch in enumerate(dataloader):
                self.predict_step(batch, batch_idx, dataloader_idx)

    def close(self):
        """Flush and close the TensorBoard writer."""
        self.writer.close()
