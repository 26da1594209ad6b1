"""Small helpers over parameter trees (counterpart of ``spiking_fullsubnet_tpu/nn/core.py``)."""

from __future__ import annotations

from typing import Callable, Optional

import torch


def cast_floating(tree, dtype: torch.dtype):
    """Cast every real floating tensor of a dict/list tree to ``dtype``
    (the mixed-precision policy: float32 parameters, compute in bf16).
    Other leaves pass through untouched."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_floating(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


_ACTIVATIONS = {
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "leakyrelu": lambda x: torch.nn.functional.leaky_relu(x, 0.01),
}


def output_activation(name: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    """None/False/missing -> identity; both generations' capitalizations."""
    if not name:
        return lambda x: x
    key = str(name).lower()
    if key in _ACTIVATIONS:
        return _ACTIVATIONS[key]
    raise NotImplementedError(f"Activation {name!r} not supported")
