"""Learning-rate schedules (counterpart of
``spiking_fullsubnet_tpu/runtime/optimization.py``; reference
audiozen/optimization.py:13-30).

Each schedule is a plain function of the update count (0 at the first
update, as optax counts) that returns the learning rate of that update.
The trainer sets every ``param_group["lr"]`` from it before each
``optimizer.step()``. The values are computed in float32, as the JAX
schedules compute them, so both packages give every update the same rate.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

_F32 = np.float32


def get_constant_schedule_with_warmup(base_lr: float, num_warmup_steps: int
                                      ) -> Callable[[int], float]:
    """LR ramps linearly from 0 over warmup then stays at base_lr."""

    def schedule(step: int) -> float:
        step = _F32(step)
        warm = step / _F32(max(1.0, float(num_warmup_steps)))
        return float(_F32(base_lr) * (warm if step < num_warmup_steps else _F32(1.0)))

    return schedule


def get_linear_schedule_with_warmup(base_lr: float, num_warmup_steps: int,
                                    num_training_steps: int) -> Callable[[int], float]:
    """Linear warmup then linear decay to 0 at num_training_steps."""

    def schedule(step: int) -> float:
        step = _F32(step)
        if step < num_warmup_steps:
            rate = step / _F32(max(1.0, float(num_warmup_steps)))
        else:
            rate = max(_F32(0.0), (_F32(num_training_steps) - step)
                       / _F32(max(1.0, float(num_training_steps - num_warmup_steps))))
        return float(_F32(base_lr) * rate)

    return schedule


def get_exponential_schedule(base_lr: float, gamma: float, steps_per_epoch: int = 1
                             ) -> Callable[[int], float]:
    """torch ExponentialLR equivalent (per-epoch gamma decay), used by the GAN
    recipes (freeze-phase run.py:33-46)."""

    def schedule(step: int) -> float:
        epoch = _F32(step) / _F32(max(1, steps_per_epoch))
        # XLA's float32 power is the float64 power rounded once
        decay = _F32(np.power(np.float64(_F32(gamma)), np.float64(np.floor(epoch))))
        return float(_F32(base_lr) * decay)

    return schedule


def get_warmup_steps(warmup_steps: int, max_steps: int, warmup_ratio: float) -> int:
    """Reference Trainer.get_warmup_steps (trainer.py:262-268)."""
    if warmup_steps > 0:
        return warmup_steps
    return math.ceil(max_steps * warmup_ratio)


def create_warmup_schedule(scheduler_name: str, base_lr: float, max_steps: int,
                           num_warmup_steps: int) -> Callable[[int], float]:
    if scheduler_name == "constant_schedule_with_warmup":
        return get_constant_schedule_with_warmup(base_lr, num_warmup_steps)
    elif scheduler_name == "linear_schedule_with_warmup":
        return get_linear_schedule_with_warmup(base_lr, num_warmup_steps, max_steps)
    raise ValueError(f"Unknown scheduler: {scheduler_name}")
