"""Small helpers over parameter trees (counterpart of ``spiking_fullsubnet_tpu/nn/core.py``).

Initializers draw float32 values from an explicit ``torch.Generator`` on the
CPU: the same tree, keys, shapes and distributions as the JAX package (torch
defaults), not the same bits."""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch


def uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    """U(-bound, bound) of ``shape``."""
    return ((torch.rand(shape, generator=gen, dtype=torch.float64) * 2.0 - 1.0) * bound).float()


def linear_init(gen: torch.Generator, in_features: int, out_features: int
                ) -> Dict[str, torch.Tensor]:
    """torch.nn.Linear default init: U(±1/sqrt(fan_in)) for weight and bias."""
    bound = 1.0 / math.sqrt(in_features) if in_features > 0 else 0.0
    return {"weight": uniform(gen, (out_features, in_features), bound),
            "bias": uniform(gen, (out_features,), bound)}


def linear_apply(params: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    y = x @ params["weight"].T
    if "bias" in params:
        y = y + params["bias"]
    return y


def layer_norm_init(normalized_shape: int) -> Dict[str, torch.Tensor]:
    return {"weight": torch.ones(normalized_shape), "bias": torch.zeros(normalized_shape)}


def layer_norm_apply(params: Dict[str, torch.Tensor], x: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """torch.nn.LayerNorm over the last dim (biased variance), written out
    as the JAX package's ``layer_norm_apply`` so that the rounding matches."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    xhat = (x - mu) * torch.rsqrt(var + eps)
    return xhat * params["weight"] + params["bias"]


def batch_norm_init(num_features: int, dtype: torch.dtype = torch.float32):
    """BatchNorm1d's (params, state) at their defaults (``core.py:85-94``)."""
    params = {"weight": torch.ones(num_features, dtype=dtype),
              "bias": torch.zeros(num_features, dtype=dtype)}
    state = {"running_mean": torch.zeros(num_features, dtype=dtype),
             "running_var": torch.ones(num_features, dtype=dtype)}
    return params, state


def batch_norm_stats(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Biased batch statistics over all axes but the last."""
    dims = tuple(range(x.ndim - 1))
    mean = x.mean(dim=dims)
    return mean, (x - mean).square().mean(dim=dims)


def batch_norm_apply(params: Dict[str, torch.Tensor], x: torch.Tensor, mean: torch.Tensor,
                     var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return (x - mean) * torch.rsqrt(var + eps) * params["weight"] + params["bias"]


def tree_map(fn, tree):
    """``fn`` over every leaf of a nested dict/list tree, the nesting kept."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


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
