"""FullSubNet, the non-spiking baseline with a cIRM output (counterpart of
``spiking_fullsubnet_tpu/models/fullsubnet.py``; reference
audiozen/models/fullsubnet.py:9-149): a fullband GRU or LSTM over every
bin, then a per-bin sub-band model over each bin's unfolded neighbours and
the fullband output's, with look-ahead padding and, in training, the
drop-band trick. Plain PyTorch on both devices: the JAX package computes it
in ``lax.scan`` and reaches no Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..dsp.feature_norm import norm_wrapper
from ..dsp.mask import drop_band
from ..nn.core import tree_map
from ..ops.freq_unfold import freq_unfold_per_bin
from ..runtime.device import resolve_device
from .rnn_sequence_model import (RnnSequenceModelConfig, rnn_sequence_model_apply,
                                 rnn_sequence_model_init)


@dataclass(frozen=True)
class FullSubNetConfig:
    num_freqs: int
    look_ahead: int
    sequence_model: str  # "GRU" | "LSTM"
    fb_num_neighbors: int
    sb_num_neighbors: int
    fb_output_activate_function: str | None
    sb_output_activate_function: str | None
    fb_model_hidden_size: int
    sb_model_hidden_size: int
    norm_type: str = "offline_laplace_norm"
    num_groups_in_drop_band: int = 2

    @property
    def sb_input_size(self) -> int:
        return (self.sb_num_neighbors * 2 + 1) + (self.fb_num_neighbors * 2 + 1)

    def fb_config(self) -> RnnSequenceModelConfig:
        return RnnSequenceModelConfig(
            input_size=self.num_freqs, output_size=self.num_freqs,
            hidden_size=self.fb_model_hidden_size, num_layers=2, bidirectional=False,
            sequence_model=self.sequence_model,
            output_activate_function=self.fb_output_activate_function or None)

    def sb_config(self) -> RnnSequenceModelConfig:
        return RnnSequenceModelConfig(
            input_size=self.sb_input_size, output_size=2,
            hidden_size=self.sb_model_hidden_size, num_layers=2, bidirectional=False,
            sequence_model=self.sequence_model,
            output_activate_function=self.sb_output_activate_function or None)


def fullsubnet_init(gen: torch.Generator, cfg: FullSubNetConfig) -> Dict[str, Any]:
    """``{"fb_model", "sb_model"}``, the JAX tree (``fullsubnet.py:63-68``)."""
    return {"fb_model": rnn_sequence_model_init(gen, cfg.fb_config()),
            "sb_model": rnn_sequence_model_init(gen, cfg.sb_config())}


def fullsubnet_apply(cfg: FullSubNetConfig, params, noisy_mag: torch.Tensor,
                     drop_band_enabled: bool = True) -> torch.Tensor:
    """``noisy_mag [B, 1, F, T]`` -> the cIRM ``[B, 2, F, T]``
    (``fullsubnet.py:71-106``). With ``drop_band_enabled``, B > 1 and more
    than one group, the sub-band model sees ``F // groups`` bins of each
    row, the rows regrouped as ``drop_band`` leaves them."""
    if noisy_mag.ndim != 4:
        raise ValueError(f"noisy_mag must be [B, 1, F, T], got {tuple(noisy_mag.shape)}")
    norm = norm_wrapper(cfg.norm_type)
    noisy_mag = F.pad(noisy_mag, (0, cfg.look_ahead))
    b, c, f, t = noisy_mag.shape
    if c != 1:
        raise ValueError("Only mono audio is supported.")
    fb_input = norm(noisy_mag).reshape(b, c * f, t)
    fb_output = rnn_sequence_model_apply(cfg.fb_config(), params["fb_model"], fb_input)
    fb_unf = freq_unfold_per_bin(fb_output.reshape(b, 1, f, t), cfg.fb_num_neighbors).reshape(
        b, f, cfg.fb_num_neighbors * 2 + 1, t)
    mag_unf = freq_unfold_per_bin(noisy_mag, cfg.sb_num_neighbors).reshape(
        b, f, cfg.sb_num_neighbors * 2 + 1, t)
    sb_input = norm(torch.cat([mag_unf, fb_unf], dim=2))  # [B, F, Fs + Ff, T]
    if b > 1 and drop_band_enabled and cfg.num_groups_in_drop_band > 1:
        sb_input = drop_band(sb_input.transpose(1, 2),
                             num_groups=cfg.num_groups_in_drop_band).transpose(1, 2)
        f = sb_input.shape[1]
    sb_mask = rnn_sequence_model_apply(cfg.sb_config(), params["sb_model"],
                                       sb_input.reshape(b * f, cfg.sb_input_size, t))
    return sb_mask.reshape(b, f, 2, t).transpose(1, 2)[..., cfg.look_ahead:]


def _apply(cfg, params, state, x, train=False):
    return {"cirm": fullsubnet_apply(cfg, params, x, train), "state": state}


def build(seed: int = 0, weight_init: bool = True, device=None, **model_args) -> Dict[str, Any]:
    """Model bundle from [model] args (``fullsubnet.py:109-118``):
    ``config``, ``apply(cfg, params, state, mag, train)`` -> ``{"cirm",
    "state"}`` (drop-band in training), ``params``, ``state`` (empty); the
    weights drawn on the CPU from ``seed`` and moved to ``device`` (default
    ``cuda``). ``false`` activations mean none."""
    model_args = {k: (None if k.endswith("activate_function") and v is False else v)
                  for k, v in model_args.items()}
    cfg = FullSubNetConfig(**model_args)
    dev = resolve_device(device)
    params = fullsubnet_init(torch.Generator().manual_seed(int(seed)), cfg)
    return {"config": cfg, "apply": _apply, "params": tree_map(lambda t: t.to(dev), params),
            "state": {}}
