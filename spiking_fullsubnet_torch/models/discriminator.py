"""The MetricGAN quality discriminator (counterpart of
``spiking_fullsubnet_tpu/models/discriminator.py``).

Four times a spectral-norm 4x4 convolution (stride 2, pad 1, no bias), an
affine instance norm and a PReLU; a max over frequency and time; a
spectral-norm linear layer, a PReLU, a second spectral-norm linear layer and
a learnable sigmoid. It scores (clean magnitude, estimated magnitude) pairs.
Spectral normalization keeps torch's semantics: in training one power
iteration updates the stored ``u`` and ``v`` (with no gradient), in eval they
are used as stored, and ``sigma = u . (W v)``.

The JAX package computes the convolutions with ``lax.conv_general_dilated``
outside any Pallas kernel; here ``torch.nn.functional.conv2d`` computes them,
on the card and on the CPU alike.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from ..nn.core import tree_map, uniform
from ..runtime.device import resolve_device


def _l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


def _spectral_norm(w2d: torch.Tensor, u: torch.Tensor, v: torch.Tensor, train: bool):
    """(sigma, u, v) (``discriminator.py:30-38``): in training one power
    iteration from the stored ``u``, without gradient."""
    if train:
        with torch.no_grad():
            v = _l2n(w2d.T @ u)
            u = _l2n(w2d @ v)
    return u @ (w2d @ v), u, v


def _normal_unit(gen: torch.Generator, n: int) -> torch.Tensor:
    return _l2n(torch.randn(n, generator=gen, dtype=torch.float64).float())


def _conv_init(gen: torch.Generator, out_ch: int, in_ch: int, k: int) -> Dict[str, torch.Tensor]:
    return {"weight": uniform(gen, (out_ch, in_ch, k, k), 1.0 / math.sqrt(in_ch * k * k)),
            "u": _normal_unit(gen, out_ch), "v": _normal_unit(gen, in_ch * k * k)}


def _linear_sn_init(gen: torch.Generator, in_f: int, out_f: int) -> Dict[str, torch.Tensor]:
    bound = 1.0 / math.sqrt(in_f)
    return {"weight": uniform(gen, (out_f, in_f), bound), "bias": uniform(gen, (out_f,), bound),
            "u": _normal_unit(gen, out_f), "v": _normal_unit(gen, in_f)}


def discriminator_init(gen: torch.Generator, ndf: int = 16, in_channel: int = 2
                       ) -> Dict[str, Any]:
    """The JAX package's tree (``discriminator.py:64-78``): the same keys,
    shapes and float32 distributions, drawn from ``gen``; other bits."""
    chans = [in_channel, ndf, ndf * 2, ndf * 4, ndf * 8]
    params: Dict[str, Any] = {"convs": [], "inorm": [], "prelu": []}
    for i in range(4):
        params["convs"].append(_conv_init(gen, chans[i + 1], chans[i], 4))
        params["inorm"].append({"weight": torch.ones(chans[i + 1]),
                                "bias": torch.zeros(chans[i + 1])})
        params["prelu"].append(torch.full((chans[i + 1],), 0.25))
    params["fc1"] = _linear_sn_init(gen, ndf * 8, ndf * 4)
    params["prelu_fc"] = torch.full((ndf * 4,), 0.25)
    params["fc2"] = _linear_sn_init(gen, ndf * 4, 1)
    params["sigmoid_slope"] = torch.ones(1)
    return params


def spectral_layers(params):
    """The layers that hold spectral-norm ``u`` and ``v``: the four
    convolutions, ``fc1`` and ``fc2``."""
    return [*params["convs"], params["fc1"], params["fc2"]]


def discriminator_weights(params):
    """The trainable tensors of the tree, in its order: every leaf but the
    power-iteration buffers ``u`` and ``v``."""
    def leaves(node):
        if isinstance(node, dict):
            return [t for k, v in node.items() if k not in ("u", "v") for t in leaves(v)]
        if isinstance(node, list):
            return [t for v in node for t in leaves(v)]
        return [node]
    return leaves(params)


def _prelu(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    a = a.reshape(1, -1, *([1] * (x.ndim - 2)))
    return torch.where(x >= 0, x, a * x)


def _instance_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """Affine InstanceNorm2d: per sample and channel over H and W, biased
    variance."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    var = (x - mu).square().mean(dim=(2, 3), keepdim=True)
    xn = (x - mu) * torch.rsqrt(var + eps)
    return xn * p["weight"][None, :, None, None] + p["bias"][None, :, None, None]


def discriminator_apply(params, x: torch.Tensor, y: torch.Tensor, train: bool = False):
    """(x = clean magnitude, y = estimated magnitude), ``[B, F, T]`` or
    ``[B, 1, F, T]`` -> (score ``[B, 1]``, new params): the new params share
    every weight with ``params`` and carry the updated ``u`` and ``v`` in
    training (``discriminator.py:96-150``). The JAX package's dropout runs
    only with a key, which no caller passes, and is left out."""
    if x.ndim == 3:
        x = x[:, None]
    if y.ndim == 3:
        y = y[:, None]
    h = torch.cat([x, y], dim=1)  # [B, 2, F, T]
    new = dict(params, convs=[dict(c) for c in params["convs"]], fc1=dict(params["fc1"]),
               fc2=dict(params["fc2"]))
    for i in range(4):
        conv = params["convs"][i]
        w = conv["weight"]
        sigma, u, v = _spectral_norm(w.reshape(w.shape[0], -1), conv["u"], conv["v"], train)
        new["convs"][i].update(u=u, v=v)
        h = F.conv2d(h, w / sigma, stride=2, padding=1)
        h = _prelu(_instance_norm(h, params["inorm"][i]), params["prelu"][i])
    h = h.amax(dim=(2, 3))  # AdaptiveMaxPool2d(1), flattened -> [B, C]
    for name in ("fc1", "fc2"):
        fc = params[name]
        sigma, u, v = _spectral_norm(fc["weight"], fc["u"], fc["v"], train)
        new[name].update(u=u, v=v)
        h = h @ (fc["weight"] / sigma).T + fc["bias"]
        if name == "fc1":
            h = _prelu(h, params["prelu_fc"])
    return torch.sigmoid(params["sigmoid_slope"] * h), new


def build(seed: int = 0, ndf: int = 16, in_channel: int = 2, device=None) -> Dict[str, Any]:
    """The JAX package's bundle (``discriminator.py:153-160``): ``config``,
    ``apply``, ``params`` (drawn on the CPU from ``seed``, moved to
    ``device``, default ``cuda``) and an empty ``state``."""
    dev = resolve_device(device)
    params = discriminator_init(torch.Generator().manual_seed(int(seed)), ndf, in_channel)
    return {"config": {"ndf": ndf, "in_channel": in_channel}, "apply": discriminator_apply,
            "params": tree_map(lambda t: t.to(dev), params), "state": {}}
