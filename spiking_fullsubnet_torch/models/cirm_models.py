"""Full-band deep-filtering models cIRM-GSN and cIRM-LSTM (counterpart of
``spiking_fullsubnet_tpu/models/cirm_models.py``): one sequence model over
every magnitude bin emits the deep-filter coefficients of every bin (proj =
F x spks x df x 2). cIRM-GSN's GSU stack runs on kernel F in eval and on
kernels D and E in training; cIRM-LSTM's recurrence is ``ops/rnn.py``'s,
plain PyTorch on either device (the JAX package has no Pallas kernel for
it), and it pads the input to a hop multiple (``pad_to_hop``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..dsp.spectral import istft_complex, stft_complex
from ..nn.core import tree_map
from ..ops.deep_filter import deep_filter
from ..runtime.device import resolve_device
from .sequence_model import SequenceModelConfig, sequence_model_apply, sequence_model_init


@dataclass(frozen=True)
class CirmModelConfig:
    n_fft: int = 512
    hop_length: int = 128
    win_length: int = 512
    fdrc: float = 0.5
    input_size: int = 257
    hidden_size: int = 256
    num_layers: int = 2
    proj_size: int = 257
    output_activate_function: Optional[str] = None
    df_order: int = 3
    use_pre_layer_norm_fb: bool = True
    bn: bool = False
    shared_weights: bool = False
    sequence_model: str = "LSTM"  # "GSN" => cirm_gsn, "LSTM" => cirm_lstm
    num_spks: int = 2
    pad_to_hop: bool = False  # cirm_lstm pads the input to a hop multiple
    compute_dtype: Optional[str] = None  # e.g. "bfloat16" (params stay f32)

    def fb_config(self) -> SequenceModelConfig:
        return SequenceModelConfig(
            input_size=self.input_size,
            hidden_size=self.hidden_size,
            num_layers=self.num_layers,
            sequence_model=self.sequence_model,
            proj_size=self.proj_size * self.num_spks * self.df_order * 2,
            shared_weights=self.shared_weights,
            output_activate_function=self.output_activate_function or None,
            bn=self.bn,
            use_pre_layer_norm=self.use_pre_layer_norm_fb,
            compute_dtype=self.compute_dtype,
        )


def cirm_model_init(seed: int, cfg: CirmModelConfig, device=None):
    """({"fb": params}, {"fb": state}) as the JAX package's tree, drawn on
    the CPU from ``seed`` and moved to ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    params, state = sequence_model_init(torch.Generator().manual_seed(int(seed)),
                                        cfg.fb_config())
    to_dev = lambda t: tree_map(lambda x: x.to(dev), t)  # noqa: E731
    return to_dev({"fb": params}), to_dev({"fb": state})


def cirm_model_apply(cfg: CirmModelConfig, params, state, noisy_y: torch.Tensor,
                     train: bool = False) -> Dict[str, Any]:
    """``noisy_y [B, T]`` -> ``enhanced_y`` (``[B, T]``, or ``[B, S, T]``),
    ``enhanced_mag`` (one speaker), ``all_layer_outputs`` and ``state`` (the
    new BN running statistics with ``train``) (``cirm_models.py:71-109``),
    on the device of ``noisy_y``."""
    if noisy_y.ndim != 2:
        raise ValueError(f"Input tensor must be 2D, but got {noisy_y.ndim}D.")
    B, sequence_length = noisy_y.shape
    if cfg.pad_to_hop:  # a whole hop more where the length is a hop multiple, as in JAX
        noisy_y = F.pad(noisy_y, (0, cfg.hop_length - sequence_length % cfg.hop_length))
    spec = stft_complex(noisy_y, cfg.n_fft, cfg.hop_length, cfg.win_length)  # [B, F, T]
    fb_output, all_layer_outputs, new_state = sequence_model_apply(
        cfg.fb_config(), params["fb"], state["fb"], spec.abs() ** cfg.fdrc, train)
    S, df, T = cfg.num_spks, cfg.df_order, fb_output.shape[-1]
    # "b (c d s f) t -> b d s f t c", c = 2
    df_coef = fb_output.reshape(B, 2, df, S, -1, T).permute(0, 2, 3, 4, 5, 1)
    enh_stft = deep_filter(spec[:, None], df_coef, df, S)  # [B, 1, S, F, T]
    flat = enh_stft.reshape(B * S, *enh_stft.shape[-2:])
    # padded: the iSTFT's own length, then cut to the input's (``:96-102``)
    enh_y = istft_complex(flat, cfg.n_fft, cfg.hop_length, cfg.win_length,
                          length=None if cfg.pad_to_hop else sequence_length)
    enh_y = enh_y[:, :sequence_length]
    out = {"all_layer_outputs": all_layer_outputs, "state": {"fb": new_state}}
    if S > 1:
        out["enhanced_y"] = enh_y.reshape(B, S, -1)
    else:
        out["enhanced_y"] = enh_y
        out["enhanced_mag"] = flat.abs()
    return out


def build(seed: int = 0, device=None, **model_args) -> Dict[str, Any]:
    """TOML [model] builder: ``config``, ``apply``, ``params``, ``state`` (as
    the JAX package's ``build``), the weights on ``device``."""
    for k, v in list(model_args.items()):
        if k.endswith("activate_function") and v is False:
            model_args[k] = None
    cfg = CirmModelConfig(**model_args)
    params, state = cirm_model_init(seed, cfg, device=device)
    return {"config": cfg, "apply": cirm_model_apply, "params": params, "state": state}
