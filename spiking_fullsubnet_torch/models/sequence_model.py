"""SequenceModel family, GSN, LSTM, LIF and ALIF backbones (counterpart of
``spiking_fullsubnet_tpu/models/sequence_model.py``): configuration, init,
and the forward of the layered path (pre-LN, the GSU stack on kernel F in
eval and on kernels D and E in training, the LSTM of ``ops/rnn.py`` or the
dense (A)LIF layers of ``ops/lif.py``, projection, output activation),
differentiable end to end."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..nn.core import (cast_floating, layer_norm_apply, layer_norm_init, linear_apply, linear_init,
                       output_activation)
from ..nn.module_tracer import trace_activation
from ..ops.gsu import gsu_stack_apply, gsu_stack_init
from ..ops.lif import lif_dense_apply, lif_dense_init
from ..ops.rnn import lstm_apply, lstm_init


@dataclass(frozen=True)
class SequenceModelConfig:
    input_size: int
    hidden_size: int
    num_layers: int
    sequence_model: str = "GSN"  # "GSN" (spiking), "LSTM", "LIF" or "ALIF"
    proj_size: int = 0
    shared_weights: bool = False
    output_activate_function: Optional[str] = None
    bn: bool = False
    use_pre_layer_norm: bool = True
    compute_dtype: Optional[str] = None
    # kept for the JAX package's configs: the port routes by device alone
    # (kernel F on a CUDA tensor, its plain version on a CPU tensor)
    backend: str = "auto"


def sequence_model_init(gen: torch.Generator, cfg: SequenceModelConfig):
    """(params, state) with ``pre_ln`` (when used), ``stack`` and ``proj``
    (when ``proj_size > 0``), as the JAX package's tree; an LSTM or (A)LIF
    stack has no state (``sequence_model.py:70-77``): the (A)LIF stack is
    ``num_layers`` dense layers of ``hidden_size`` without bias."""
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    if cfg.use_pre_layer_norm:
        params["pre_ln"] = layer_norm_init(cfg.input_size)
    if cfg.sequence_model == "GSN":
        params["stack"], state["stack"] = gsu_stack_init(
            gen, cfg.input_size, cfg.hidden_size, cfg.num_layers, cfg.shared_weights, cfg.bn)
    elif cfg.sequence_model == "LSTM":
        params["stack"], state["stack"] = lstm_init(gen, cfg.input_size, cfg.hidden_size,
                                                    cfg.num_layers), {}
    elif cfg.sequence_model in ("LIF", "ALIF"):
        sizes = [cfg.input_size] + [cfg.hidden_size] * cfg.num_layers
        params["stack"], state["stack"] = lif_dense_init(gen, sizes), {}
    else:
        raise NotImplementedError(f"Sequence model {cfg.sequence_model} not implemented.")
    if cfg.proj_size > 0:
        params["proj"] = linear_init(gen, cfg.hidden_size, cfg.proj_size)
    return params, state


def sequence_model_apply(cfg: SequenceModelConfig, params: Dict[str, Any],
                         state: Dict[str, Any], x: torch.Tensor, train: bool = False
                         ) -> Tuple[torch.Tensor, List[torch.Tensor], Dict[str, Any]]:
    """``x [B, F, T]`` -> (output ``[B, proj|H, T]`` in x's type,
    all_layer_outputs (time-major: the stack input, every layer's spikes,
    and for the GSN the projection; none for the LSTM, ``:128-143``),
    state)
    (``sequence_model.py:86-149``); with ``train``
    the state holds the updated BN running statistics. With
    ``compute_dtype`` the input and every floating parameter (the BN affine
    included, not the running statistics) are cast to it first; the casts
    are differentiable, so gradients return in the parameters' own type.
    An open activation tracer records ``pre_ln`` and ``proj`` here
    (``sequence_model.py:110-141``) and the GSU layers' frames in
    ``gsu_stack_apply``."""
    if x.ndim != 3:
        raise ValueError(f"Input tensor must be 3D, but got {x.ndim}D.")
    xt = x.permute(2, 0, 1)  # [T, B, F]
    out_dtype = xt.dtype
    if cfg.compute_dtype is not None:
        cdt = getattr(torch, cfg.compute_dtype)
        xt = xt.to(cdt)
        params = cast_floating(params, cdt)
    if cfg.use_pre_layer_norm:
        xt = trace_activation("pre_ln", layer_norm_apply(params["pre_ln"], xt))
    if cfg.sequence_model == "GSN":
        out, all_layer_outputs, new_stack = gsu_stack_apply(
            params["stack"], state["stack"], xt, cfg.hidden_size, cfg.shared_weights, train)
        new_state = dict(state, stack=new_stack)
    elif cfg.sequence_model in ("LIF", "ALIF"):
        # the "ALIF" leaderboard row's backbone: dense + (adaptive) LIF per
        # layer, the last layer's spikes out
        out, all_layer_outputs = lif_dense_apply(
            params["stack"], xt, adaptive=cfg.sequence_model == "ALIF", last_layer_spikes=True)
        new_state = state
    else:
        out = lstm_apply(params["stack"], xt, cfg.hidden_size)
        all_layer_outputs, new_state = [], state
    if cfg.proj_size > 0:
        out = trace_activation("proj", linear_apply(params["proj"], out))
        if cfg.sequence_model == "GSN":
            all_layer_outputs = all_layer_outputs + [out]
    out = output_activation(cfg.output_activate_function)(out).permute(1, 2, 0)  # [B, F', T]
    if cfg.compute_dtype is not None:
        out = out.to(out_dtype)
    return out, all_layer_outputs, new_state


def subband_sequence_model_apply(cfg: SequenceModelConfig, params: Dict[str, Any],
                                 state: Dict[str, Any], x: torch.Tensor, df_order: int,
                                 num_spks: int, train: bool = False):
    """``x [B, N, C, fs, T]`` with the sub-band units folded into the batch
    -> (deep-filter coefficients ``[B, df, S, N fc, T, 2]``, all_layer_outputs,
    state) (``sequence_model.py:155-182``): the projection's columns are
    ``(c fc df s)`` with c = 2 (real, imaginary)."""
    B, N, C, fs, T = x.shape
    if C != 1:
        raise ValueError("Only mono audio is supported.")
    out, all_layer_outputs, new_state = sequence_model_apply(
        cfg, params, state, x.reshape(B * N, C * fs, T), train)
    fc = out.shape[1] // (2 * C * df_order * num_spks)
    out = out.reshape(B, N, 2 * C, fc, df_order, num_spks, T)
    out = out.permute(0, 4, 5, 1, 3, 6, 2).reshape(B, df_order, num_spks, N * fc, T, 2 * C)
    return out, all_layer_outputs, new_state
