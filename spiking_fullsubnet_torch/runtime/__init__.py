"""The trainer runtime: configuration, registry, schedules, logging,
checkpoints, the trainer, weight conversion and debugging (counterpart of
``spiking_fullsubnet_tpu/runtime``; reference layer 4). The names the JAX
package's ``runtime/__init__.py`` re-exports, resolved at first use
(``_exports.py``)."""

from .._exports import lazy_exports, table_of

_NAMES = table_of({
    "config": ("toml_load", "toml_loads", "toml_dump"),
    "registry": ("instantiate", "resolve", "build_optimizer_factory"),
    "optimization": ("get_constant_schedule_with_warmup", "get_linear_schedule_with_warmup",
                     "get_exponential_schedule", "create_warmup_schedule", "get_warmup_steps"),
    "trainer_state": ("TrainerState",),
    "logging_": ("TensorboardLogger", "init_logging_logger"),
    "checkpoint": ("CheckpointManager",),
    "trainer": ("Trainer",),
    "convert": ("load_torch_state_dict", "import_spiking_fullsubnet", "save_npz"),
    "debug": ("enable_debug_nans", "detect_overflow", "clamp_inf_value"),
})
__all__ = sorted(_NAMES)
__getattr__, __dir__ = lazy_exports(__name__, _NAMES)
