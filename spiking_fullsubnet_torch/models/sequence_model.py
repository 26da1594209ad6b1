"""SequenceModel configuration and init (counterpart of
``spiking_fullsubnet_tpu/models/sequence_model.py:33-83``). Only the GSN
branch of the init is ported; the layered SequenceModel forward is not
ported yet (ROADMAP queue 1, item 5)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..nn.core import layer_norm_init, linear_init
from ..ops.gsu import gsu_stack_init


@dataclass(frozen=True)
class SequenceModelConfig:
    input_size: int
    hidden_size: int
    num_layers: int
    sequence_model: str = "GSN"  # "GSN" (spiking) or "LSTM"
    proj_size: int = 0
    shared_weights: bool = False
    output_activate_function: Optional[str] = None
    bn: bool = False
    use_pre_layer_norm: bool = True
    compute_dtype: Optional[str] = None
    backend: str = "auto"


def sequence_model_init(gen: torch.Generator, cfg: SequenceModelConfig):
    """(params, state) with ``pre_ln`` (when used), ``stack`` and ``proj``
    (when ``proj_size > 0``), as the JAX package's tree."""
    if cfg.sequence_model != "GSN":
        raise NotImplementedError(
            f"sequence_model={cfg.sequence_model!r}: only the GSN init is ported "
            "(ROADMAP queue 1, item 12: the remaining models)")
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    if cfg.use_pre_layer_norm:
        params["pre_ln"] = layer_norm_init(cfg.input_size)
    params["stack"], state["stack"] = gsu_stack_init(
        gen, cfg.input_size, cfg.hidden_size, cfg.num_layers, cfg.shared_weights, cfg.bn)
    if cfg.proj_size > 0:
        params["proj"] = linear_init(gen, cfg.hidden_size, cfg.proj_size)
    return params, state
