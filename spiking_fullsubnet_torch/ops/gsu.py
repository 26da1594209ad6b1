"""Gated Spiking Unit (GSU) recurrence, eval forward (counterpart of
``spiking_fullsubnet_tpu/ops/gsu.py``).

Cell math (reference efficient_spiking_neuron.py:132-153):
    gates = x @ W_ih^T + b_ih + h @ W_hh^T          # no b_hh
    f, g  = split(gates); f = sigmoid(f)
    c'    = f * c + (1 - f) * g
    c''   = BN(c')              eval: a folded affine of the running stats
    h'    = spike(c'')          binary; -0.0 >= 0 fires
The carried membrane is c'' (after BN). With shared weights the gate and
cell halves share W and only the bias differs. bf16/f16 inputs accumulate in
float32 and every gate, membrane and BN value stays float32.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..nn.core import uniform

BN_EPS = 1e-5


def gsu_cell_init(gen: torch.Generator, input_size: int, hidden_size: int,
                  shared_weights: bool = False, bn: bool = False):
    """One GSU cell (reference reset_parameters): U(±1/sqrt(H)) on
    ``weight_ih``, ``weight_hh`` and ``bias_ih``; BN affine and running
    statistics at their defaults. Returns (params, state)."""
    stdv = 1.0 / math.sqrt(hidden_size) if hidden_size > 0 else 0.0
    rows = hidden_size if shared_weights else 2 * hidden_size
    params: Dict[str, Any] = {
        "weight_ih": uniform(gen, (rows, input_size), stdv),
        "weight_hh": uniform(gen, (rows, hidden_size), stdv),
        "bias_ih": uniform(gen, (2 * hidden_size,), stdv),
    }
    state: Dict[str, Any] = {}
    if bn:
        params["bn"] = {"weight": torch.ones(hidden_size), "bias": torch.zeros(hidden_size)}
        state["bn"] = {"running_mean": torch.zeros(hidden_size),
                       "running_var": torch.ones(hidden_size)}
    return params, state


def gsu_stack_init(gen: torch.Generator, input_size: int, hidden_size: int, num_layers: int,
                   shared_weights: bool = False, bn: bool = False):
    """A stack of GSU layers: ({"layers": [...]}, {"layers": [...]})."""
    layers, states = [], []
    for i in range(num_layers):
        p, s = gsu_cell_init(gen, input_size if i == 0 else hidden_size, hidden_size,
                             shared_weights, bn)
        layers.append(p)
        states.append(s)
    return {"layers": layers}, {"layers": states}


class Spike(torch.autograd.Function):
    """Heaviside(x >= 0) with the triangle surrogate gradient
    ``grad * max(gamma - |x|, 0) / gamma^2`` (efficient_spiking_neuron.py:84-101)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.gamma = gamma
        return (x >= 0.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        gamma = ctx.gamma
        surr = (1.0 / (gamma * gamma)) * torch.clamp(gamma - x.abs(), min=0.0)
        return g * surr, None


def spike(x: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    return Spike.apply(x, gamma)


def acc_dtype_for(io_dtype: torch.dtype) -> torch.dtype:
    """Low-precision streams accumulate in float32; f32/f64 stay as they are."""
    return torch.float32 if io_dtype in (torch.bfloat16, torch.float16) else io_dtype


def bn_eval_affine(params: Dict[str, Any], bn_state: Dict[str, Any],
                   dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval BatchNorm as ``cy * scale + shift``, computed in the running
    stats' own type (float32 in the checkpoints) and cast to ``dtype``."""
    rm = bn_state["bn"]["running_mean"]
    rv = bn_state["bn"]["running_var"]
    w = params["bn"]["weight"].to(rv.dtype)
    b = params["bn"]["bias"].to(rv.dtype)
    scale = w * torch.rsqrt(rv + BN_EPS)
    return scale.to(dtype), (b - rm * scale).to(dtype)


def gsu_stack_apply(
    params: Dict[str, Any],
    state: Dict[str, Any],
    x: torch.Tensor,  # [T, B, F] time-major
    hidden_size: int,
    shared_weights: bool = False,
    train: bool = False,
) -> Tuple[torch.Tensor, List[torch.Tensor], Dict[str, Any]]:
    """The stacked GSU over a time-major sequence, eval (``ops/gsu.py:261``):
    ``(out [T, B, H], [x] + every layer's spikes, state)``, spikes in x's
    type. A CUDA tensor goes to kernel F (``gsu_kernels.gsu_stack_eval_x``),
    a CPU tensor to its plain version.

    The JAX package's dispatch sends a TPU input to its Pallas kernel only
    for ``T >= 8`` and falls back to the scan when the shape misses the VMEM
    plan (``ops/gsu.py:285-293``). Both clauses are TPU rules and are
    dropped: kernel F takes any T >= 1 and nothing falls back."""
    from .gsu_kernels import gsu_stack_eval_x, pack_stack_x

    if train:
        raise NotImplementedError(
            "training is not ported yet (ROADMAP queue 1 items 4 and 8; kernels D/E of "
            "queue 2)")
    packed = pack_stack_x(params["layers"], state["layers"], hidden_size, x.dtype)
    spikes = gsu_stack_eval_x(x.contiguous(), *packed, hidden_size, shared_weights)
    outs = list(spikes.unbind(0))
    return outs[-1], [x] + outs, state


def gsu_layer_eval(
    params: Dict[str, Any],
    bn_state: Dict[str, Any],
    x: Optional[torch.Tensor],  # [T, B, F] time-major, or None
    hidden_size: int,
    shared_weights: bool,
    precomputed_xg: Optional[torch.Tensor] = None,  # [T, B, rows]
) -> torch.Tensor:
    """One GSU layer over a sequence in eval mode -> spikes ``[T, B, H]``
    in the input's type. ``precomputed_xg`` gives the input gates (no bias)
    in place of ``x`` (the serving path hoists layer 0's projection)."""
    io = (precomputed_xg if x is None else x).dtype
    acc = acc_dtype_for(io)
    H = hidden_size
    if x is None:
        xg = precomputed_xg.to(acc)
    else:
        T, B, Fin = x.shape
        xg = (x.reshape(T * B, Fin).to(acc) @ params["weight_ih"].to(acc).T).reshape(T, B, -1)
    T, B, _ = xg.shape
    w_hh_t = params["weight_hh"].to(acc).T
    b = params["bias_ih"].to(acc)
    b_f, b_c = b[:H], b[H:]
    use_bn = "bn" in params
    if use_bn:
        scale, shift = bn_eval_affine(params, bn_state, acc)
    h = torch.zeros(B, H, dtype=acc, device=xg.device)
    c = torch.zeros(B, H, dtype=acc, device=xg.device)
    out = torch.empty(T, B, H, dtype=io, device=xg.device)
    for t in range(T):
        rg = h @ w_hh_t
        if shared_weights:
            f_in = xg[t] + rg + b_f
            c_in = xg[t] + rg + b_c
        else:
            f_in = xg[t, :, :H] + rg[:, :H] + b_f
            c_in = xg[t, :, H:] + rg[:, H:] + b_c
        f = torch.sigmoid(f_in)
        c = f * c + (1.0 - f) * c_in
        if use_bn:
            c = c * scale + shift
        h = spike(c)
        out[t] = h.to(io)
    return out
