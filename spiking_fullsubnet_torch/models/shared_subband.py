"""The shared sub-band ablation: one GSU stack for every frequency section
(counterpart of ``spiking_fullsubnet_tpu/models/shared_subband.py``;
reference recipes/intel_ndns/spiking_fullsubnet_freeze_phase/
model_low_freq_shared_subband.py, whose output loop the JAX package
completed).

Per-section linear adapters project each section's unfolded input into a
common ``sb_shared_bottleneck``; every section's units are folded into one
batch of rows for ONE shared sequence model; per-section output adapters
give each section's deep-filter coefficients. In eval the shared GSU stack
runs on kernel F, in training each of its layers on kernels D and E, with
the batch statistics over every section's units at once.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..dsp.feature_norm import norm_wrapper
from ..nn.core import linear_init
from ..ops.freq_unfold import freq_unfold
from .sequence_model import SequenceModelConfig, sequence_model_apply, sequence_model_init


def shared_stack_config(cfg) -> SequenceModelConfig:
    """The shared stack: bottleneck in, ``sb_hidden_size`` units, the
    projection back to the bottleneck (``shared_subband.py:60-74``)."""
    return SequenceModelConfig(
        input_size=cfg.sb_shared_bottleneck,
        hidden_size=cfg.sb_hidden_size,
        num_layers=cfg.sb_num_layers,
        sequence_model=cfg.sequence_model,
        proj_size=cfg.sb_shared_bottleneck,
        shared_weights=cfg.shared_weights,
        output_activate_function=None,
        bn=cfg.bn,
        use_pre_layer_norm=cfg.use_pre_layer_norm_sb,
        compute_dtype=cfg.compute_dtype,
        backend=cfg.backend,
    )


def shared_subband_init(gen: torch.Generator, cfg) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params ``{"lin_in", "lin_out", "stack"}``, state ``{"stack"}``) as
    the JAX tree (``shared_subband.py:39-57``): section i's adapters map
    its input width to the bottleneck and the bottleneck to ``2 ctr df S``
    coefficients."""
    lin_in, lin_out = [], []
    for i in range(cfg.num_sections):
        out_size = cfg.center_freq_sizes[i] * 2 * cfg.df_orders[i] * cfg.num_spks
        lin_in.append(linear_init(gen, cfg.sb_config(i).input_size, cfg.sb_shared_bottleneck))
        lin_out.append(linear_init(gen, cfg.sb_shared_bottleneck, out_size))
    stack_params, stack_state = sequence_model_init(gen, shared_stack_config(cfg))
    return ({"lin_in": lin_in, "lin_out": lin_out, "stack": stack_params},
            {"stack": stack_state})


def _adapter(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``x [B, N, f, T]`` through a linear layer on f (``"bnft,of->bnot"``)."""
    return torch.einsum("bnft,of->bnot", x, p["weight"]) + p["bias"][None, None, :, None]


def shared_subband_forward(cfg, params: Dict[str, Any], state: Dict[str, Any],
                           noisy_mag: torch.Tensor, fb_output: torch.Tensor,
                           train: bool = False, fused: bool = False
                           ) -> Tuple[List[torch.Tensor], List[List[torch.Tensor]], Dict[str, Any]]:
    """``noisy_mag``, ``fb_output`` ``[B, 1, F, T]`` -> (each section's
    coefficients ``[B, df, S, N fc, T, 2]``, the shared stack's layer
    outputs once per section, the new state) (``shared_subband.py:77-135``):
    the contract of ``spiking_fullsubnet._subband_forward``, whose ``fused``
    gather this takes too."""
    norm = norm_wrapper(cfg.norm_type) if cfg.norm_type else None
    feats = []
    for idx in range(cfg.num_sections):
        lo, hi = cfg.freq_cutoffs[idx], cfg.freq_cutoffs[idx + 1]
        noisy_sub = freq_unfold(noisy_mag, lo, hi, cfg.center_freq_sizes[idx],
                                cfg.neighbor_freq_sizes[idx])
        fb_sub = freq_unfold(fb_output, lo, hi, cfg.fb_ctrs[idx], cfg.fb_nbrs[idx],
                             cfg.num_freqs if fused else 0)
        sb_input = torch.cat([noisy_sub, fb_sub], dim=-2)  # [B, N, 1, fs, T]
        if norm is not None:
            sb_input = norm(sb_input)
        feats.append(_adapter(params["lin_in"][idx], sb_input.flatten(2, 3)))
    B, T = noisy_mag.shape[0], noisy_mag.shape[-1]
    n_units = [f.shape[1] for f in feats]
    stacked = torch.cat(feats, dim=1)  # [B, N_total, bottleneck, T]
    out, all_layer_outputs, new_stack = sequence_model_apply(
        shared_stack_config(cfg), params["stack"], state["stack"],
        stacked.reshape(B * sum(n_units), -1, T), train)
    out = out.reshape(B, sum(n_units), -1, T)
    coefs, offset = [], 0
    for idx, n in enumerate(n_units):
        c = _adapter(params["lin_out"][idx], out[:, offset:offset + n])  # [B, N, (2 fc df S), T]
        offset += n
        df, S = cfg.df_orders[idx], cfg.num_spks
        fc = c.shape[2] // (2 * df * S)
        c = c.reshape(B, n, 2, fc, df, S, T).permute(0, 4, 5, 1, 3, 6, 2)
        coefs.append(c.reshape(B, df, S, n * fc, T, 2))
    return coefs, [all_layer_outputs] * cfg.num_sections, {"stack": new_stack}
