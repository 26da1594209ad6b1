"""Conv-TasNet, the time-domain separation baseline (counterpart of
``spiking_fullsubnet_tpu/models/conv_tasnet.py``; reference
audiozen/models/conv_tasnet, torchaudio's architecture): a convolutional
encoder, a TCN mask estimator (dilated depthwise blocks with global layer
norm, PReLU, residual and skip paths) and a transposed-convolution decoder.

The JAX package computes these convolutions with ``lax.conv``, outside any
Pallas kernel, so the port computes them with
``torch.nn.functional.conv1d``/``conv_transpose1d`` on either device (on
the card cuDNN's; TF32 follows ``torch.backends.cudnn.allow_tf32``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from ..nn.core import tree_map, uniform
from ..runtime.device import resolve_device


def _conv1d_init(gen: torch.Generator, out_ch: int, in_ch_per_group: int, k: int,
                 bias: bool = True) -> Dict[str, torch.Tensor]:
    """torch.nn.Conv1d's init: U(±1/sqrt(fan_in)) for weight and bias."""
    bound = 1.0 / math.sqrt(in_ch_per_group * k)
    p = {"weight": uniform(gen, (out_ch, in_ch_per_group, k), bound)}
    if bias:
        p["bias"] = uniform(gen, (out_ch,), bound)
    return p


def _conv1d(x: torch.Tensor, p, stride: int = 1, padding: int = 0, dilation: int = 1,
            groups: int = 1) -> torch.Tensor:
    """``x [B, C, T]``, weight ``[O, I/g, K]`` (torch layout)."""
    return F.conv1d(x, p["weight"], p.get("bias"), stride=stride, padding=padding,
                    dilation=dilation, groups=groups)


def _conv_transpose1d(x: torch.Tensor, p, stride: int = 1, padding: int = 0) -> torch.Tensor:
    """torch ConvTranspose1d, weight ``[in, out, k]``: out_len =
    (L - 1)·stride + k - 2·padding (``conv_tasnet.py:50-68``)."""
    return F.conv_transpose1d(x, p["weight_t"], p.get("bias"), stride=stride, padding=padding)


def _glob_ln(x: torch.Tensor, p, eps: float = 1e-8) -> torch.Tensor:
    """GroupNorm with one group: layer norm over (C, T)."""
    mu = x.mean(dim=(1, 2), keepdim=True)
    var = (x - mu).square().mean(dim=(1, 2), keepdim=True)
    xn = (x - mu) * torch.rsqrt(var + eps)
    return xn * p["weight"][None, :, None] + p["bias"][None, :, None]


def _prelu1(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, a * x)


def _norm_init(n: int) -> Dict[str, torch.Tensor]:
    return {"weight": torch.ones(n), "bias": torch.zeros(n)}


@dataclass(frozen=True)
class ConvTasNetConfig:
    num_sources: int = 2
    enc_kernel_size: int = 16
    enc_num_feats: int = 512
    msk_kernel_size: int = 3
    msk_num_feats: int = 128
    msk_num_hidden_feats: int = 512
    msk_num_layers: int = 8
    msk_num_stacks: int = 3
    msk_activate: str = "sigmoid"

    @property
    def enc_stride(self):
        return self.enc_kernel_size // 2


def conv_tasnet_init(seed: int, cfg: ConvTasNetConfig, device=None) -> Dict[str, Any]:
    """The JAX package's parameter tree (same keys, shapes and bounds; other
    bits), drawn on the CPU from ``seed`` and moved to ``device`` (default
    ``cuda``) (``conv_tasnet.py:98-144``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    hid = cfg.msk_num_hidden_feats
    params: Dict[str, Any] = {
        "encoder": _conv1d_init(gen, cfg.enc_num_feats, 1, cfg.enc_kernel_size, bias=False),
        "input_norm": _norm_init(cfg.enc_num_feats),
        "input_conv": _conv1d_init(gen, cfg.msk_num_feats, cfg.enc_num_feats, 1),
    }
    blocks: List[Dict[str, Any]] = []
    for stack in range(cfg.msk_num_stacks):
        for layer in range(cfg.msk_num_layers):
            blk = {"conv1": _conv1d_init(gen, hid, cfg.msk_num_feats, 1),
                   "prelu1": torch.full((1,), 0.25),
                   "norm1": _norm_init(hid),
                   "dconv": _conv1d_init(gen, hid, 1, cfg.msk_kernel_size),
                   "prelu2": torch.full((1,), 0.25),
                   "norm2": _norm_init(hid),
                   "skip_out": _conv1d_init(gen, cfg.msk_num_feats, hid, 1)}
            # the last block of the last stack has no residual output
            if not (layer == cfg.msk_num_layers - 1 and stack == cfg.msk_num_stacks - 1):
                blk["res_out"] = _conv1d_init(gen, cfg.msk_num_feats, hid, 1)
            blocks.append(blk)
    params["blocks"] = blocks
    params["output_prelu"] = torch.full((1,), 0.25)
    params["output_conv"] = _conv1d_init(gen, cfg.enc_num_feats * cfg.num_sources,
                                         cfg.msk_num_feats, 1)
    # torch ConvTranspose1d's layout [in, out, k]; its bound 1/sqrt(out·k), out = 1
    params["decoder"] = {"weight_t": uniform(gen, (cfg.enc_num_feats, 1, cfg.enc_kernel_size),
                                             1.0 / math.sqrt(cfg.enc_kernel_size))}
    return tree_map(lambda t: t.to(dev), params)


def conv_tasnet_apply(cfg: ConvTasNetConfig, params, x: torch.Tensor) -> torch.Tensor:
    """``x [B, T]`` waveform -> ``[B, num_sources, T]``
    (``conv_tasnet.py:146-193``), on the device of ``x``."""
    if x.ndim != 2:
        raise ValueError(f"Input tensor must be 2D, but got {x.ndim}D.")
    b, t = x.shape
    x = x[:, None, :]  # [B, 1, T]
    # pad to the stride (modeling_conv_tasnet.py:233-275)
    is_odd = cfg.enc_kernel_size % 2
    num_strides = (t - is_odd) // cfg.enc_stride
    num_rem = t - (is_odd + num_strides * cfg.enc_stride)
    num_pads = 0 if num_rem == 0 else cfg.enc_stride - num_rem
    if num_pads:
        x = F.pad(x, (0, num_pads))
    t_pad = x.shape[-1]

    feats = _conv1d(x, params["encoder"], stride=cfg.enc_stride, padding=cfg.enc_stride)
    h = _conv1d(_glob_ln(feats, params["input_norm"]), params["input_conv"])
    skip_sum = 0.0
    blocks = iter(params["blocks"])
    for _ in range(cfg.msk_num_stacks):
        for layer in range(cfg.msk_num_layers):
            blk = next(blocks)
            dilation = 2 ** layer
            f = _glob_ln(_prelu1(_conv1d(h, blk["conv1"]), blk["prelu1"]), blk["norm1"])
            f = _conv1d(f, blk["dconv"], padding=dilation, dilation=dilation,
                        groups=cfg.msk_num_hidden_feats)
            f = _glob_ln(_prelu1(f, blk["prelu2"]), blk["norm2"])
            if "res_out" in blk:
                h = h + _conv1d(f, blk["res_out"])
            skip_sum = skip_sum + _conv1d(f, blk["skip_out"])

    out = _conv1d(_prelu1(skip_sum, params["output_prelu"]), params["output_conv"])
    out = torch.sigmoid(out) if cfg.msk_activate == "sigmoid" else torch.relu(out)
    mask = out.reshape(b, cfg.num_sources, cfg.enc_num_feats, -1)
    masked = (mask * feats[:, None]).reshape(b * cfg.num_sources, cfg.enc_num_feats, -1)
    decoded = _conv_transpose1d(masked, params["decoder"], stride=cfg.enc_stride,
                                padding=cfg.enc_stride)
    out = decoded.reshape(b, cfg.num_sources, t_pad)
    return out[..., :t] if num_pads else out


def conv_tasnet_base(num_sources: int = 2) -> ConvTasNetConfig:
    """The highest-SI-SNR configuration (modeling_conv_tasnet.py:307-330)."""
    return ConvTasNetConfig(num_sources=num_sources, enc_kernel_size=16, enc_num_feats=512,
                            msk_kernel_size=3, msk_num_feats=128, msk_num_hidden_feats=512,
                            msk_num_layers=8, msk_num_stacks=3, msk_activate="relu")


def _apply(cfg: ConvTasNetConfig, params, state, x: torch.Tensor, train: bool = False):
    return {"enhanced_y": conv_tasnet_apply(cfg, params, x), "all_layer_outputs": [],
            "state": state}


def build(seed: int = 0, device=None, base: bool = False, **model_args) -> Dict[str, Any]:
    """The TOML [model] entry: ``config``, ``apply``, ``params``, ``state``
    (as the JAX package's ``build``, ``conv_tasnet.py:211-223``), the
    weights on ``device``."""
    cfg = conv_tasnet_base(**model_args) if base else ConvTasNetConfig(**model_args)
    return {"config": cfg, "apply": _apply, "params": conv_tasnet_init(seed, cfg, device),
            "state": {}}
