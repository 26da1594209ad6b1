"""LIF and ALIF spiking neurons (counterpart of
``spiking_fullsubnet_tpu/ops/lif.py``; reference recipes/intel_ndns/
spiking_fullsubnet_freeze_phase/neuron.py:222-297): leaky
integrate-and-fire with the GSU's firing (``ops/gsu.spike``: Heaviside,
triangle surrogate), soft or hard reset, optionally a detached reset; ALIF
adds a threshold that a trace of past spikes raises. The membrane
recurrence is a loop over the frames and the dense layers ``torch.matmul``,
on the CPU and on the card alike: the JAX package runs them in
``lax.scan`` and reaches no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..nn.core import uniform
from .gsu import spike


def lif_sequence(x: torch.Tensor, tau: float = 2.0, v_threshold: float = 1.0,
                 hard_reset: bool = False, detach_reset: bool = False,
                 v0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """LIF over ``x [T, B, F]`` input currents (``lif.py:27-64``)::

        v_t  = v_{t-1} exp(-1/tau) + x_t
        s_t  = spike(v_t - theta)
        v_t <- v_t (1 - s_t)     hard reset
               v_t - s_t theta   soft reset (the default)

    With ``detach_reset`` the reset term takes the spike without its
    gradient; the spikes returned keep theirs. Returns (spikes ``[T, B,
    F]``, the last membrane ``[B, F]``)."""
    decay = math.exp(-1.0 / tau)
    v = torch.zeros_like(x[0]) if v0 is None else v0
    spikes = []
    for x_t in x:
        v = v * decay + x_t
        s = spike(v - v_threshold)
        s_reset = s.detach() if detach_reset else s
        v = v * (1.0 - s_reset) if hard_reset else v - s_reset * v_threshold
        spikes.append(s)
    return torch.stack(spikes), v


def alif_sequence(x: torch.Tensor, tau: float = 2.0, tau_adp: float = 20.0,
                  v_threshold: float = 1.0, beta: float = 1.8, hard_reset: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adaptive-threshold LIF (``lif.py:67-101``): ``theta_t = theta_0 +
    beta a_t``, ``a`` a leaky trace of the spikes (``a <- rho a + (1 - rho)
    s``, rho = exp(-1/tau_adp)). Returns (spikes, the last membrane)."""
    decay = math.exp(-1.0 / tau)
    rho = math.exp(-1.0 / tau_adp)
    v = torch.zeros_like(x[0])
    a = torch.zeros_like(x[0])
    spikes = []
    for x_t in x:
        v = v * decay + x_t
        theta = v_threshold + beta * a
        s = spike(v - theta)
        a = rho * a + (1.0 - rho) * s
        v = v * (1.0 - s) if hard_reset else v - s * theta
        spikes.append(s)
    return torch.stack(spikes), v


def lif_dense_init(gen: torch.Generator, sizes):
    """Dense feed-forward SNN weights, ``sizes = [in, h1, ..., out]``:
    ``{"layers": [{"weight": [out, in]}, ...]}``, U(±1/sqrt(in)), no bias
    (``lif.py:107-115``)."""
    return {"layers": [{"weight": uniform(gen, (sizes[i + 1], sizes[i]),
                                          1.0 / math.sqrt(sizes[i]))}
                       for i in range(len(sizes) - 1)]}


def lif_dense_apply(params, x: torch.Tensor, tau: float = 2.0, v_threshold: float = 1.0,
                    adaptive: bool = False, last_layer_spikes: bool = False):
    """A dense layer then (A)LIF per layer over ``x [T, B, F]``
    (``lif.py:118-140``). The last layer is a leaky integrator without
    firing (its membranes are the output) unless ``last_layer_spikes``.
    Returns (output ``[T, B, F_out]``, [x, every layer's output])."""
    seq = alif_sequence if adaptive else lif_sequence
    out = x
    all_layer_outputs = [x]
    n = len(params["layers"])
    for i, layer in enumerate(params["layers"]):
        cur = out @ layer["weight"].T
        if i < n - 1 or last_layer_spikes:
            out, _ = seq(cur, tau=tau, v_threshold=v_threshold)
        else:
            decay = math.exp(-1.0 / tau)
            v, vs = torch.zeros_like(cur[0]), []
            for c in cur:
                v = v * decay + c
                vs.append(v)
            out = torch.stack(vs)
        all_layer_outputs.append(out)
    return out, all_layer_outputs
