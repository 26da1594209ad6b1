"""LSTM and GRU recurrences with torch.nn.LSTM / torch.nn.GRU semantics
(counterpart of ``spiking_fullsubnet_tpu/ops/rnn.py``): the same parameter
tree, gate orders (LSTM i, f, g, o; GRU r, z, n) and bias conventions, so
that the JAX package's weights carry across as they are.

A layer is written as the JAX package writes it: one product for the input
projection of every frame, then a loop over the frames with only the
``[B, H] x [H, gates·H]`` recurrent product inside. The same formulation
runs on the CPU and on the card; it is plain PyTorch, because the JAX
package computes it in ``lax.scan`` and has no Pallas kernel for it. A
faster recurrence on the card (a persistent kernel, or cuDNN's) is later
performance work.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import torch

from ..nn.core import uniform


def _cell_init(gen: torch.Generator, input_size: int, hidden_size: int, gates: int
               ) -> Dict[str, torch.Tensor]:
    stdv = 1.0 / math.sqrt(hidden_size) if hidden_size > 0 else 0.0
    return {"weight_ih": uniform(gen, (gates * hidden_size, input_size), stdv),
            "weight_hh": uniform(gen, (gates * hidden_size, hidden_size), stdv),
            "bias_ih": uniform(gen, (gates * hidden_size,), stdv),
            "bias_hh": uniform(gen, (gates * hidden_size,), stdv)}


def _stack_init(gen: torch.Generator, input_size: int, hidden_size: int, num_layers: int,
                bidirectional: bool, gates: int) -> Dict[str, Any]:
    dirs = 2 if bidirectional else 1
    layers: List[Dict[str, Any]] = []
    for layer in range(num_layers):
        in_size = input_size if layer == 0 else hidden_size * dirs
        entry = {"fwd": _cell_init(gen, in_size, hidden_size, gates)}
        if bidirectional:
            entry["bwd"] = _cell_init(gen, in_size, hidden_size, gates)
        layers.append(entry)
    return {"layers": layers}


def lstm_init(gen: torch.Generator, input_size: int, hidden_size: int, num_layers: int,
              bidirectional: bool = False) -> Dict[str, Any]:
    """torch.nn.LSTM's parameters, U(±1/sqrt(H)), as the JAX package's tree
    (``rnn.py:33-44``)."""
    return _stack_init(gen, input_size, hidden_size, num_layers, bidirectional, 4)


def gru_init(gen: torch.Generator, input_size: int, hidden_size: int, num_layers: int,
             bidirectional: bool = False) -> Dict[str, Any]:
    """torch.nn.GRU's parameters, U(±1/sqrt(H)) (``rnn.py:47-58``)."""
    return _stack_init(gen, input_size, hidden_size, num_layers, bidirectional, 3)


def _frames(T: int, reverse: bool):
    return range(T - 1, -1, -1) if reverse else range(T)


def _lstm_direction(p, x: torch.Tensor, hidden_size: int, reverse: bool = False) -> torch.Tensor:
    """``x [T, B, F] -> [T, B, H]`` (``rnn.py:61-81``)."""
    T, B, F = x.shape
    H = hidden_size
    xg = (x.reshape(T * B, F) @ p["weight_ih"].T + p["bias_ih"] + p["bias_hh"]).reshape(
        T, B, 4 * H)
    w_hh = p["weight_hh"].T
    h = x.new_zeros(B, H)
    c = x.new_zeros(B, H)
    out = [None] * T
    for t in _frames(T, reverse):
        g = xg[t] + h @ w_hh
        i = torch.sigmoid(g[:, :H])
        f = torch.sigmoid(g[:, H:2 * H])
        gg = torch.tanh(g[:, 2 * H:3 * H])
        o = torch.sigmoid(g[:, 3 * H:])
        c = f * c + i * gg
        h = o * torch.tanh(c)
        out[t] = h
    return torch.stack(out)


def _gru_direction(p, x: torch.Tensor, hidden_size: int, reverse: bool = False) -> torch.Tensor:
    """``x [T, B, F] -> [T, B, H]`` (``rnn.py:84-100``)."""
    T, B, F = x.shape
    H = hidden_size
    xg = (x.reshape(T * B, F) @ p["weight_ih"].T + p["bias_ih"]).reshape(T, B, 3 * H)
    w_hh = p["weight_hh"].T
    h = x.new_zeros(B, H)
    out = [None] * T
    for t in _frames(T, reverse):
        hg = h @ w_hh + p["bias_hh"]
        r = torch.sigmoid(xg[t, :, :H] + hg[:, :H])
        z = torch.sigmoid(xg[t, :, H:2 * H] + hg[:, H:2 * H])
        n = torch.tanh(xg[t, :, 2 * H:] + r * hg[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        out[t] = h
    return torch.stack(out)


def _stack_apply(params, x: torch.Tensor, hidden_size: int, direction_fn: Callable,
                 bidirectional: bool) -> torch.Tensor:
    out = x
    for layer in params["layers"]:
        fwd = direction_fn(layer["fwd"], out, hidden_size)
        if bidirectional:
            bwd = direction_fn(layer["bwd"], out, hidden_size, reverse=True)
            out = torch.cat([fwd, bwd], dim=-1)
        else:
            out = fwd
    return out


def lstm_apply(params, x: torch.Tensor, hidden_size: int, bidirectional: bool = False
               ) -> torch.Tensor:
    """``x [T, B, F]`` time-major -> ``[T, B, H·dirs]``."""
    return _stack_apply(params, x, hidden_size, _lstm_direction, bidirectional)


def gru_apply(params, x: torch.Tensor, hidden_size: int, bidirectional: bool = False
              ) -> torch.Tensor:
    """``x [T, B, F]`` time-major -> ``[T, B, H·dirs]``."""
    return _stack_apply(params, x, hidden_size, _gru_direction, bidirectional)
