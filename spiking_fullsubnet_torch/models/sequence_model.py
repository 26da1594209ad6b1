"""SequenceModel configuration (counterpart of the fields of
``spiking_fullsubnet_tpu/models/sequence_model.py:33-51`` that
``fb_config``/``sb_config`` fill in). The layered SequenceModel forward is
not ported yet (ROADMAP queue 1, item 5)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


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
