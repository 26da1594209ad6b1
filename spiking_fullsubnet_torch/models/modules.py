"""Generic sequence and convolution building blocks (counterpart of
``spiking_fullsubnet_tpu/models/modules.py``; reference
audiozen/models/module/): the reference's research spares, which no recipe's
main path runs.

- cLN (cumulative layer norm), DepthConv1d, TCNEstimator   (tcn_block.py)
- TransformAverageConcatenate (TAC)                         (tac.py)
- ResidualLSTM                                              (res_lstm.py)
- CumulativeMagSpectralNorm / cumulative_norm               (feature_norm.py)
- GroupedLinear, SharedGroupGRU                             (groupGRU.py)
- LayerNormLSTM                                             (custom_lstm.py)
- MogrifierLSTM                                             (mogrifier_lstm.py)
- causal conformer convolution block                        (causal_conformer_conv.py)
- complex MVDR helpers                                      (module/utils.py)

Plain functions on tensors over the JAX package's parameter trees, so that
its weights carry across with ``runtime/convert.params_from_numpy``; the
``*_init`` functions draw from a ``torch.Generator`` on the CPU (the same
trees and distributions, not the same bits). The JAX package has no
Pallas kernel here: the convolutions are ``torch.nn.functional.conv1d``,
the recurrences the loops of ``ops/rnn.py`` (its LSTM and GRU where the
math is the same), on either device.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..dsp.mask import EPSILON
from ..nn.core import layer_norm_apply, layer_norm_init, linear_apply, linear_init, uniform
from ..ops.rnn import gru_apply, gru_init, lstm_apply, lstm_init

Tree = Dict[str, Any]


def _affine(n: int) -> Tree:
    return {"gain": torch.ones(n), "bias": torch.zeros(n)}


# ------------------------------------------------------------------ norms


def cumulative_layer_norm_affine(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
                                 eps: float = EPSILON) -> torch.Tensor:
    """cLN (tcn_block.py:13-54): causal layer norm over (C, t' <= t) with
    affine. ``x [B, C, T]``, gain and bias ``[C]``."""
    _, c, t = x.shape
    cum_sum = torch.cumsum(x.sum(dim=1), dim=-1)
    cum_pow = torch.cumsum(x.square().sum(dim=1), dim=-1)
    cnt = torch.arange(c, c * (t + 1), c, dtype=x.dtype, device=x.device)[None, :]
    mean = cum_sum / cnt
    var = (cum_pow - 2 * mean * cum_sum) / cnt + mean ** 2
    std = torch.sqrt(var + eps)
    xn = (x - mean[:, None, :]) / std[:, None, :]
    return xn * gain[None, :, None] + bias[None, :, None]


def cumulative_mag_spectral_norm(x: torch.Tensor, cumulative: bool = False,
                                 use_mid_freq_mu: bool = False,
                                 eps: float = EPSILON) -> torch.Tensor:
    """CumulativeMagSpectralNorm (feature_norm.py:52-111). ``x [B, C, F, T]``."""
    b, c, f, t = x.shape
    xr = x.reshape(b * c, f, t)
    step = xr[:, int(f // 2 - 1), :] if use_mid_freq_mu else xr.mean(dim=1)
    if cumulative:
        cnt = torch.arange(1, t + 1, dtype=x.dtype, device=x.device)[None, :]
        mu = (torch.cumsum(step, dim=-1) / cnt)[:, None, :]
    else:
        mu = step.mean(dim=-1)[:, None, None]
    return (xr / (mu + eps)).reshape(b, c, f, t)


def cumulative_norm(x: torch.Tensor) -> torch.Tensor:
    """cumulative_norm (feature_norm.py:7-49): causal zero-norm of ``[B, C, F, T]``."""
    from ..dsp.feature_norm import cumulative_layer_norm

    return cumulative_layer_norm(x)


# ------------------------------------------------------------------ TCN


def _conv_init(gen: torch.Generator, out_ch: int, in_ch_g: int, width: int) -> Tree:
    bound = 1.0 / math.sqrt(in_ch_g * width)
    return {"weight": uniform(gen, (out_ch, in_ch_g, width), bound),
            "bias": uniform(gen, (out_ch,), bound)}


def _conv1d(x: torch.Tensor, p: Tree, padding: int = 0, dilation: int = 1,
            groups: int = 1) -> torch.Tensor:
    return F.conv1d(x, p["weight"], p.get("bias"), padding=padding, dilation=dilation,
                    groups=groups)


def _prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, a * x)


def _gln(x: torch.Tensor, p: Tree, eps: float = EPSILON) -> torch.Tensor:
    mu = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mu).square().mean(dim=(1, 2), keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["gain"][None, :, None] + p["bias"][None, :, None]


def depth_conv1d_init(gen: torch.Generator, input_channel: int, hidden_channel: int,
                      kernel: int, causal: bool = False, skip: bool = True) -> Tree:
    """DepthConv1d's parameters (tcn_block.py:57-115)."""
    p = {"conv1d": _conv_init(gen, hidden_channel, input_channel, 1),
         "dconv1d": _conv_init(gen, hidden_channel, 1, kernel),
         "res_out": _conv_init(gen, input_channel, hidden_channel, 1),
         "prelu1": torch.full((1,), 0.25), "prelu2": torch.full((1,), 0.25),
         "reg1": _affine(hidden_channel), "reg2": _affine(hidden_channel)}
    if skip:
        p["skip_out"] = _conv_init(gen, input_channel, hidden_channel, 1)
    return p


def depth_conv1d_apply(p: Tree, x: torch.Tensor, kernel: int, dilation: int = 1,
                       padding: int = 0, causal: bool = False, skip: bool = True):
    """(residual, skip) or residual (tcn_block.py:100-115). ``x [B, C, T]``."""
    def norm(h, q):
        return cumulative_layer_norm_affine(h, q["gain"], q["bias"]) if causal else _gln(h, q)

    h = norm(_prelu(_conv1d(x, p["conv1d"]), p["prelu1"]), p["reg1"])
    pad = (kernel - 1) * dilation if causal else padding
    h = _conv1d(h, p["dconv1d"], padding=pad, dilation=dilation, groups=h.shape[1])
    if causal and pad > 0:
        h = h[:, :, :-pad]
    h = norm(_prelu(h, p["prelu2"]), p["reg2"])
    residual = _conv1d(h, p["res_out"])
    if skip:
        return residual, _conv1d(h, p["skip_out"])
    return residual


def tcn_estimator_init(gen: torch.Generator, input_dim: int, output_dim: int, bn_dim: int,
                       hidden_dim: int, layer: int = 8, stack: int = 3, kernel: int = 3,
                       causal: bool = True) -> Tree:
    """TCNEstimator's parameters (tcn_block.py:117-216)."""
    bn = {"weight": uniform(gen, (bn_dim, input_dim, 1), 1.0 / math.sqrt(input_dim)),
          "bias": torch.zeros(bn_dim)}
    tcn = [depth_conv1d_init(gen, bn_dim, hidden_dim, kernel, causal=causal)
           for _ in range(stack * layer)]
    out = {"weight": uniform(gen, (output_dim, bn_dim, 1), 1.0 / math.sqrt(bn_dim)),
           "bias": torch.zeros(output_dim)}
    return {"LN": _affine(input_dim), "BN": bn, "TCN": tcn, "output": out}


def tcn_estimator_apply(params: Tree, x: torch.Tensor, layer: int = 8, stack: int = 3,
                        kernel: int = 3, causal: bool = True,
                        dilated: bool = True) -> torch.Tensor:
    """``x [B, N, T]`` -> ``[B, output_dim, T]``."""
    if causal:
        h = cumulative_layer_norm_affine(x, params["LN"]["gain"], params["LN"]["bias"])
    else:
        h = _gln(x, params["LN"])
    h = _conv1d(h, params["BN"])
    skip_sum = 0.0
    for idx in range(stack * layer):
        d = 2 ** (idx % layer) if dilated else 1
        residual, skip = depth_conv1d_apply(params["TCN"][idx], h, kernel, dilation=d,
                                            padding=d, causal=causal, skip=True)
        h = h + residual
        skip_sum = skip_sum + skip
    return _conv1d(skip_sum, params["output"])


# ------------------------------------------------------------------ TAC


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def tac_init(gen: torch.Generator, input_size: int, hidden_size: int) -> Tree:
    """TransformAverageConcatenate's parameters (tac.py:9-54)."""
    return {"transform": linear_init(gen, input_size, hidden_size),
            "average": linear_init(gen, hidden_size, hidden_size),
            "output": linear_init(gen, hidden_size * 2, input_size),
            "norm": _affine(input_size)}


def tac_apply(params: Tree, x: torch.Tensor) -> torch.Tensor:
    """``x [B, G, F, T]`` -> ``[B, G, F, T]`` with information exchanged
    across the G groups."""
    b, g, f, t = x.shape
    h = _gln(x.reshape(b * g, f, t), params["norm"]).reshape(b, g, f, t)
    h = h.permute(0, 3, 1, 2)  # [B, T, G, F]
    group = _gelu(linear_apply(params["transform"], h))  # [B, T, G, H]
    mean = _gelu(linear_apply(params["average"], group.mean(dim=2)))  # [B, T, H]
    mean = mean[:, :, None, :].expand_as(group)
    out = _gelu(linear_apply(params["output"], torch.cat([group, mean], dim=-1)))
    return x + out.permute(0, 2, 3, 1)


# ------------------------------------------------------------------ ResidualLSTM


def residual_lstm_init(gen: torch.Generator, input_size: int, output_size: int,
                       hidden_size: int) -> Tree:
    """ResidualLSTM's parameters (res_lstm.py:9-33)."""
    return {"in_conv": {"weight": uniform(gen, (hidden_size, input_size, 1),
                                          1.0 / math.sqrt(input_size))},
            "lstm_1": lstm_init(gen, hidden_size, hidden_size, 1),
            "lstm_2": lstm_init(gen, hidden_size, hidden_size, 1),
            "linear": linear_init(gen, hidden_size, output_size),
            "norm_1": layer_norm_init(hidden_size),
            "norm_2": layer_norm_init(output_size)}


def residual_lstm_apply(params: Tree, x: torch.Tensor, hidden_size: int,
                        use_activation: bool = True) -> torch.Tensor:
    """``x [B, F, T]`` -> ``[B, output_size, T]``. Both residual LSTMs take
    ``norm_1``, as the JAX function does."""
    h = F.conv1d(x, params["in_conv"]["weight"]).permute(2, 0, 1)  # [T, B, H]
    h = h + layer_norm_apply(params["norm_1"], lstm_apply(params["lstm_1"], h, hidden_size))
    h = h + layer_norm_apply(params["norm_1"], lstm_apply(params["lstm_2"], h, hidden_size))
    h = layer_norm_apply(params["norm_2"], linear_apply(params["linear"], h))
    if use_activation:
        h = torch.relu(h)
    return h.permute(1, 2, 0)


# ------------------------------------------------------------------ grouped layers


def grouped_linear_init(gen: torch.Generator, input_size: int, hidden_size: int,
                        groups: int = 1) -> Tree:
    """GroupedLinear (groupGRU.py:405-440): a weight ``[G, I/G, H/G]`` a
    group, N(0, 2 / (I/G))."""
    if input_size % groups or hidden_size % groups:
        raise ValueError(f"input {input_size} and hidden {hidden_size} must divide by {groups}")
    ws = input_size // groups
    w = torch.randn((groups, ws, hidden_size // groups), generator=gen, dtype=torch.float64)
    return {"weight": (w * math.sqrt(2.0 / ws)).float()}


def grouped_linear_apply(params: Tree, x: torch.Tensor, groups: int) -> torch.Tensor:
    """``x [..., I]`` -> ``[..., H]`` with the block-diagonal weight."""
    *lead, i = x.shape
    out = torch.einsum("bgi,gih->bgh", x.reshape(-1, groups, i // groups), params["weight"])
    return out.reshape(*lead, -1)


def shared_group_gru_init(gen: torch.Generator, input_size: int, hidden_size: int,
                          num_layers: int = 1, num_groups: int = 4) -> Tree:
    """SharedGroupGRU (groupGRU.py:99-206): one GRU a layer shared by the G
    groups, the channels shuffled between layers."""
    if input_size % num_groups or hidden_size % num_groups:
        raise ValueError(f"input {input_size} and hidden {hidden_size} must divide by "
                         f"{num_groups}")
    return {"layers": [gru_init(gen, (input_size if li == 0 else hidden_size) // num_groups,
                                hidden_size // num_groups, 1) for li in range(num_layers)]}


def shared_group_gru_apply(params: Tree, x: torch.Tensor, hidden_size: int,
                           num_groups: int) -> torch.Tensor:
    """``x [T, B, I]`` -> ``[T, B, H]``; the groups share the weights
    through a fold into the batch."""
    t, b, _ = x.shape
    h = x
    for layer in params["layers"]:
        i = h.shape[-1]
        hg = h.reshape(t, b, num_groups, i // num_groups).permute(0, 2, 1, 3)
        out = gru_apply(layer, hg.reshape(t, num_groups * b, i // num_groups),
                        hidden_size // num_groups)
        # channel shuffle: the groups interleave between layers
        h = out.reshape(t, num_groups, b, -1).permute(0, 2, 3, 1).reshape(t, b, -1)
    return h


# ------------------------------------------------------------------ LayerNormLSTM


def layer_norm_lstm_init(gen: torch.Generator, input_size: int, hidden_size: int,
                         num_layers: int = 1) -> Tree:
    """LayerNormLSTM (custom_lstm.py:71-220): layer norm on the gate
    pre-activations and on the cell."""
    stdv = 1.0 / math.sqrt(hidden_size)
    layers = []
    for li in range(num_layers):
        in_size = input_size if li == 0 else hidden_size
        layers.append({"weight_ih": uniform(gen, (4 * hidden_size, in_size), stdv),
                       "weight_hh": uniform(gen, (4 * hidden_size, hidden_size), stdv),
                       "ln_ih": layer_norm_init(4 * hidden_size),
                       "ln_hh": layer_norm_init(4 * hidden_size),
                       "ln_cell": layer_norm_init(hidden_size)})
    return {"layers": layers}


def layer_norm_lstm_apply(params: Tree, x: torch.Tensor, hidden_size: int) -> torch.Tensor:
    """``x [T, B, F]`` -> ``[T, B, H]``."""
    H = hidden_size
    out = x
    for layer in params["layers"]:
        T, B, Fin = out.shape
        xg = layer_norm_apply(layer["ln_ih"], out.reshape(T * B, Fin) @ layer["weight_ih"].T
                              ).reshape(T, B, 4 * H)
        w_hh = layer["weight_hh"].T
        h = c = x.new_zeros(B, H)
        hs = []
        for t in range(T):
            g = xg[t] + layer_norm_apply(layer["ln_hh"], h @ w_hh)
            i = torch.sigmoid(g[:, :H])
            f = torch.sigmoid(g[:, H:2 * H])
            gg = torch.tanh(g[:, 2 * H:3 * H])
            o = torch.sigmoid(g[:, 3 * H:])
            c = layer_norm_apply(layer["ln_cell"], f * c + i * gg)
            h = o * torch.tanh(c)
            hs.append(h)
        out = torch.stack(hs)
    return out


# ------------------------------------------------------------------ MogrifierLSTM


def mogrifier_lstm_init(gen: torch.Generator, input_size: int, hidden_size: int,
                        mogrify_steps: int = 5) -> Tree:
    """MogrifierLSTM (mogrifier_lstm.py): x and h gate each other before an
    LSTM cell; even rounds update x from h, odd rounds h from x."""
    mog = [linear_init(gen, hidden_size, input_size) if i % 2 == 0
           else linear_init(gen, input_size, hidden_size) for i in range(mogrify_steps)]
    return {"mogrify": mog, "lstm": lstm_init(gen, input_size, hidden_size, 1)}


def mogrifier_lstm_apply(params: Tree, x: torch.Tensor, hidden_size: int,
                         mogrify_steps: int = 5) -> torch.Tensor:
    """``x [T, B, F]`` -> ``[T, B, H]`` (one layer)."""
    H = hidden_size
    cell = params["lstm"]["layers"][0]["fwd"]
    T, B, _ = x.shape
    h = c = x.new_zeros(B, H)
    hs = []
    for t in range(T):
        xt = x[t]
        for i, lin in enumerate(params["mogrify"]):
            if i % 2 == 0:
                xt = 2 * torch.sigmoid(linear_apply(lin, h)) * xt
            else:
                h = 2 * torch.sigmoid(linear_apply(lin, xt)) * h
        g = (xt @ cell["weight_ih"].T + cell["bias_ih"] + h @ cell["weight_hh"].T
             + cell["bias_hh"])
        i_g = torch.sigmoid(g[:, :H])
        f_g = torch.sigmoid(g[:, H:2 * H])
        g_g = torch.tanh(g[:, 2 * H:3 * H])
        o_g = torch.sigmoid(g[:, 3 * H:])
        c = f_g * c + i_g * g_g
        h = o_g * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


# ------------------------------------------------------------------ conformer conv


def causal_conformer_conv_init(gen: torch.Generator, channels: int, kernel_size: int = 15
                               ) -> Tree:
    """Causal conformer convolution module (causal_conformer_conv.py): LN ->
    pointwise (2C) -> GLU -> causal depthwise -> cLN -> swish -> pointwise."""
    def conv(out_ch, in_ch, k, fan):
        return {"weight": uniform(gen, (out_ch, in_ch, k), 1.0 / math.sqrt(fan)),
                "bias": torch.zeros(out_ch)}

    return {"ln": layer_norm_init(channels),
            "pw1": conv(2 * channels, channels, 1, channels),
            "dw": conv(channels, 1, kernel_size, kernel_size),
            "norm": _affine(channels),
            "pw2": conv(channels, channels, 1, channels)}


def causal_conformer_conv_apply(params: Tree, x: torch.Tensor, kernel_size: int = 15
                                ) -> torch.Tensor:
    """``x [B, C, T]`` -> ``[B, C, T]``, causal."""
    _, c, t = x.shape
    h = layer_norm_apply(params["ln"], x.transpose(1, 2)).transpose(1, 2)
    a, g = _conv1d(h, params["pw1"]).chunk(2, dim=1)
    h = a * torch.sigmoid(g)  # GLU
    h = _conv1d(h, params["dw"], padding=kernel_size - 1, groups=c)[:, :, :t]
    h = cumulative_layer_norm_affine(h, params["norm"]["gain"], params["norm"]["bias"])
    h = h * torch.sigmoid(h)  # swish
    return x + _conv1d(h, params["pw2"])


# ------------------------------------------------------------------ MVDR / complex helpers


def complex_outer(spec: torch.Tensor) -> torch.Tensor:
    """Per-(f, t) outer product for the spatial covariance. ``spec [B, C, F, T]``."""
    return torch.einsum("bcft,bdft->bcdft", spec, spec.conj())


def spatial_covariance(spec: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       eps: float = 1e-8) -> torch.Tensor:
    """Mask-weighted spatial covariance (module/utils.py's MVDR helpers):
    ``spec [B, C, F, T]`` complex, ``mask [B, F, T]`` real -> ``[B, F, C, C]``."""
    if mask is None:
        mask = torch.ones(spec.shape[0:1] + spec.shape[2:], dtype=spec.real.dtype,
                          device=spec.device)
    num = torch.einsum("bft,bcft,bdft->bfcd", mask.to(spec.dtype), spec, spec.conj())
    return num / (mask.sum(dim=-1)[..., None, None] + eps)


def mvdr_weights(phi_speech: torch.Tensor, phi_noise: torch.Tensor, ref_channel: int = 0,
                 eps: float = 1e-8) -> torch.Tensor:
    """MVDR beamformer w = (Phi_n^-1 Phi_s / tr(Phi_n^-1 Phi_s)) e_ref:
    ``phi_* [B, F, C, C]`` complex -> ``[B, F, C]``."""
    c = phi_noise.shape[-1]
    phi_noise = phi_noise + eps * torch.eye(c, dtype=phi_noise.dtype, device=phi_noise.device)
    num = torch.linalg.solve(phi_noise, phi_speech)
    trace = torch.diagonal(num, dim1=-2, dim2=-1).sum(-1)[..., None, None] + eps
    return (num / trace)[..., ref_channel]


def apply_beamforming(spec: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``spec [B, C, F, T]``, ``weights [B, F, C]`` -> ``[B, F, T]``."""
    return torch.einsum("bfc,bcft->bft", weights.conj(), spec)
