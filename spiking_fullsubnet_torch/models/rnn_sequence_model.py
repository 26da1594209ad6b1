"""The RNN sequence model of the non-spiking models, GRU or LSTM then a
linear layer and an activation (counterpart of
``spiking_fullsubnet_tpu/models/rnn_sequence_model.py``; reference
audiozen/models/module/sequence_model.py:9-217), on ``ops/rnn.py``."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from ..nn.core import linear_apply, linear_init, output_activation
from ..ops.rnn import gru_apply, gru_init, lstm_apply, lstm_init


@dataclass(frozen=True)
class RnnSequenceModelConfig:
    input_size: int
    output_size: int
    hidden_size: int
    num_layers: int
    bidirectional: bool = False
    sequence_model: str = "GRU"
    output_activate_function: Optional[str] = "Tanh"


def rnn_sequence_model_init(gen: torch.Generator, cfg: RnnSequenceModelConfig
                            ) -> Dict[str, Any]:
    """``{"stack", "fc_output_layer"}`` (the latter when ``output_size``)
    as the JAX tree (``rnn_sequence_model.py:33-45``)."""
    if cfg.sequence_model == "GRU":
        init = gru_init
    elif cfg.sequence_model == "LSTM":
        init = lstm_init
    else:
        raise NotImplementedError(f"Not implemented {cfg.sequence_model}")
    params = {"stack": init(gen, cfg.input_size, cfg.hidden_size, cfg.num_layers,
                            cfg.bidirectional)}
    if int(cfg.output_size):
        dirs = 2 if cfg.bidirectional else 1
        params["fc_output_layer"] = linear_init(gen, cfg.hidden_size * dirs, cfg.output_size)
    return params


def rnn_sequence_model_apply(cfg: RnnSequenceModelConfig, params, x: torch.Tensor
                             ) -> torch.Tensor:
    """``x [B, F, T] -> [B, output_size, T]`` (``rnn_sequence_model.py:48-57``)."""
    apply = gru_apply if cfg.sequence_model == "GRU" else lstm_apply
    out = apply(params["stack"], x.permute(2, 0, 1), cfg.hidden_size, cfg.bidirectional)
    if "fc_output_layer" in params:
        out = linear_apply(params["fc_output_layer"], out)
    return output_activation(cfg.output_activate_function)(out).permute(1, 2, 0)
