"""Gated Spiking Unit (GSU) recurrence, eval and training (counterpart of
``spiking_fullsubnet_tpu/ops/gsu.py`` and of ``gsu_stack_apply_pallas``).

Cell math (reference efficient_spiking_neuron.py:132-153):
    gates = x @ W_ih^T + b_ih + h @ W_hh^T          # no b_hh
    f, g  = split(gates); f = sigmoid(f)
    c'    = f * c + (1 - f) * g
    c''   = BN(c')              eval: a folded affine of the running stats;
                                training: each step's batch statistics
    h'    = spike(c'')          binary; -0.0 >= 0 fires
The carried membrane is c'' (after BN). With shared weights the gate and
cell halves share W and only the bias differs. bf16/f16 inputs accumulate in
float32 and every gate, membrane and BN value stays float32. Eval runs a
whole stack on kernel F; training runs each layer on kernels D and E
(``GSULayerTrain``), whose backward passes the spike gradient through the
triangle surrogate.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..nn.core import uniform

BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # torch BatchNorm1d's, the only value the JAX package passes


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


def bn_running_update(running: Dict[str, torch.Tensor], means: torch.Tensor,
                      vars_: torch.Tensor, batch_rows: int) -> Dict[str, torch.Tensor]:
    """Fold T per-step batch statistics into the running statistics
    (``ops/gsu.py:240-258``): torch's per-step ``r <- (1 - m) r + m stat``
    (the variance unbiased by R / max(R - 1, 1)) in closed form over the T
    steps, in the running statistics' own type."""
    T = means.shape[0]
    sd = running["running_mean"].dtype
    means, vars_ = means.to(sd), vars_.to(sd)
    m = BN_MOMENTUM
    decay = (1.0 - m) ** torch.arange(T - 1, -1, -1, dtype=sd, device=means.device)
    unbiased = vars_ * (batch_rows / max(batch_rows - 1, 1))
    return {"running_mean": (1.0 - m) ** T * running["running_mean"]
            + m * torch.einsum("t,th->h", decay, means),
            "running_var": (1.0 - m) ** T * running["running_var"]
            + m * torch.einsum("t,th->h", decay, unbiased)}


class GSULayerTrain(torch.autograd.Function):
    """One GSU layer in training (``_gsu_train_core`` with its custom_vjp,
    ``gsu_pallas.py:557-577``): the forward is kernel D with batch-statistics
    BN (or none), the backward kernel E.

    ``apply(xg [T, R, rows], weight_hh [rows, H], bias_ih [2H], bn_weight,
    bn_bias, hidden, shared)`` with xg the input gates without bias and the
    BN affine None without BN -> (spikes ``[T, R, H]`` in xg's type, stats
    ``[T, 2, H]`` = per-step (mean, biased var), not differentiable). xg's
    type is the kernels' stream type (``_KCfg.io``): float32 on the layered
    path, bfloat16 on the stream-train path under the bf16 policy, float64
    on the CPU; ``weight_hh`` goes to the kernels in it, the bias and the BN
    affine in the accumulation type (float32 beside bfloat16), where the
    membranes and statistics stay. Gradients flow to xg, weight_hh, bias_ih
    and the BN affine, each in its own type. The kernels are looked up in
    ``gsu_kernels`` at each call."""

    @staticmethod
    def forward(ctx, xg, weight_hh, bias_ih, bn_weight, bn_bias, hidden: int, shared: bool):
        from . import gsu_kernels as gk

        io = xg.dtype
        acc = acc_dtype_for(io)
        mode = "none" if bn_weight is None else "bn"
        whh = weight_hh.to(io).T.contiguous()  # [H, G]: h @ whh, f half first
        b2 = bias_ih.to(acc).reshape(2, hidden).contiguous()
        if bn_weight is None:
            bnp = torch.stack([torch.ones_like(b2[0]), torch.zeros_like(b2[0])])
        else:
            bnp = torch.stack([bn_weight.to(acc), bn_bias.to(acc)])
        xg = xg.contiguous()
        spikes, y, stats = gk.gsu_layer_train_fwd(xg, whh, b2, bnp, hidden, shared, mode)
        ctx.save_for_backward(xg, whh, b2, bnp, y, stats)
        ctx.meta = (hidden, shared, mode, weight_hh.dtype, bias_ih.dtype,
                    None if bn_weight is None else bn_weight.dtype)
        ctx.mark_non_differentiable(stats)
        return spikes, stats

    @staticmethod
    def backward(ctx, g_spikes, _g_stats):
        from . import gsu_kernels as gk

        xg, whh, b2, bnp, y, stats = ctx.saved_tensors
        hidden, shared, mode, w_dt, b_dt, bn_dt = ctx.meta
        dxg, dw, db, dbn = gk.gsu_layer_train_bwd(
            xg, y, g_spikes.to(xg.dtype).contiguous(), stats, whh, b2, bnp, hidden, shared, mode)
        d_bn_w = d_bn_b = None
        if bn_dt is not None:
            d_bn_w, d_bn_b = dbn[0].to(bn_dt), dbn[1].to(bn_dt)
        return (dxg, dw.T.to(w_dt), db.reshape(-1).to(b_dt), d_bn_w, d_bn_b, None, None)


def gsu_stack_train_xg(params: Dict[str, Any], state: Dict[str, Any], xg0: torch.Tensor,
                       hidden_size: int, shared_weights: bool
                       ) -> Tuple[List[torch.Tensor], Dict[str, Any]]:
    """A GSU stack in training from layer 0's input gates ``xg0 [T, R,
    rows]`` (no bias), whose type is the stream type: every layer on
    ``GSULayerTrain`` (kernels D and E), the inter-layer input products
    ``spikes @ W_ih^T`` summed in the accumulation type and rounded to the
    stream type, the running statistics updated from each layer's batch
    statistics over the R rows. Returns (every layer's spikes in the stream
    type, the new stack state). The per-layer loop of
    ``gsu_stack_apply_pallas`` (``gsu_pallas.py:703-742``) and of the
    stream-train stack ``_stack_train_xg`` (``stream_forward.py:203-256``)
    at the real widths."""
    io = xg0.dtype
    acc = acc_dtype_for(io)
    T, R, _ = xg0.shape
    spikes, new_states = [], []
    for k, (lp, ls) in enumerate(zip(params["layers"], state["layers"])):
        if k == 0:
            xg = xg0
        else:
            xg = (spikes[-1].reshape(T * R, -1).to(acc) @ lp["weight_ih"].to(acc).T
                  ).reshape(T, R, -1).to(io)
        bn = lp.get("bn")
        bn_w, bn_b = (bn["weight"], bn["bias"]) if bn is not None else (None, None)
        spk, stats = GSULayerTrain.apply(xg, lp["weight_hh"], lp["bias_ih"], bn_w, bn_b,
                                         hidden_size, shared_weights)
        ns = ls
        if bn is not None:
            ns = {"bn": bn_running_update(ls["bn"], stats[:, 0], stats[:, 1], R)}
        spikes.append(spk)
        new_states.append(ns)
    return spikes, {"layers": new_states}


def gsu_stack_apply(
    params: Dict[str, Any],
    state: Dict[str, Any],
    x: torch.Tensor,  # [T, B, F] time-major
    hidden_size: int,
    shared_weights: bool = False,
    train: bool = False,
) -> Tuple[torch.Tensor, List[torch.Tensor], Dict[str, Any]]:
    """The stacked GSU over a time-major sequence (``ops/gsu.py:261``):
    ``(out [T, B, H], [x] + every layer's spikes, state)``, spikes in x's
    type. A CUDA tensor goes to the kernels, a CPU tensor to their plain
    versions.

    Eval runs the whole stack on kernel F (``gsu_kernels.gsu_stack_eval_x``)
    and returns ``state`` as given. Training runs the per-layer loop of
    ``gsu_stack_apply_pallas`` (``gsu_pallas.py:703-742``) through
    ``gsu_stack_train_xg``: the hoisted input projection ``xg = x @
    W_ih^T`` with a float32 (float64 for f64 input) result, so float32
    streams through kernels D and E, and the running statistics updated
    from the batch statistics over the B rows.

    The JAX package's dispatch sends a TPU input to its Pallas kernels only
    for ``T >= 8`` and falls back to the scan when the shape misses the VMEM
    plan (``ops/gsu.py:285-293``). Both clauses are TPU rules and are
    dropped: the kernels take any T >= 1 and nothing falls back."""
    from .gsu_kernels import gsu_stack_eval_x, pack_stack_x

    if not train:
        packed = pack_stack_x(params["layers"], state["layers"], hidden_size, x.dtype)
        spikes = gsu_stack_eval_x(x.contiguous(), *packed, hidden_size, shared_weights)
        outs = list(spikes.unbind(0))
        return outs[-1], [x] + outs, state
    acc = acc_dtype_for(x.dtype)
    T, B, F = x.shape
    w0 = params["layers"][0]["weight_ih"].to(acc)
    xg0 = (x.reshape(T * B, F).to(acc) @ w0.T).reshape(T, B, -1)
    spikes, new_state = gsu_stack_train_xg(params, state, xg0, hidden_size, shared_weights)
    outs = [s.to(x.dtype) for s in spikes]
    return outs[-1], [x] + outs, new_state


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
