"""Neuromorphic cost proxies: synaptic and neuron operations (counterpart of
``spiking_fullsubnet_tpu/metrics/neuromorphic.py``; reference
audiozen/metric.py:303-340, the Intel N-DNS "power_proxy_Ops/s" and
"PDP_proxy_Ops" leaderboard columns), over the spike tensors of the
forward's collect lists (``fb_all_layer_outputs``/``sb_all_layer_outputs``).
"""

from __future__ import annotations

import numpy as np
import torch


def _layer_pairs(fb_all_layer_outputs, sb_all_layer_outputs):
    """(layer i, layer i + 1) of every hidden spiking layer: the input and
    the final projection are excluded."""
    for layers in [fb_all_layer_outputs, *sb_all_layer_outputs]:
        for i in range(1, len(layers) - 1):
            yield layers[i], layers[i + 1]


def compute_synops(fb_all_layer_outputs, sb_all_layer_outputs,
                   shared_weights: bool = True) -> float:
    """Spike-rate-weighted synaptic operations on the host (metric.py:303-327):
    for each hidden spiking layer, rate(out_i) * fan_in_i * (fan_out_i +
    recurrent fan_in_i), in float64."""
    synops = 0.0
    for cur, nxt in _layer_pairs(fb_all_layer_outputs, sb_all_layer_outputs):
        cur = cur.detach().cpu().numpy() if isinstance(cur, torch.Tensor) else np.asarray(cur)
        synops += float((cur > 0).mean()) * cur.shape[-1] * (nxt.shape[-1] + cur.shape[-1])
    return synops if shared_weights else 2 * synops


def compute_neuronops(fb_all_layer_outputs, sb_all_layer_outputs) -> float:
    """Neuron count proxy (metric.py:330-340): shape arithmetic only."""
    neuronops = 0.0
    for layers in [fb_all_layer_outputs, *sb_all_layer_outputs]:
        for x in layers:
            neuronops += x.shape[-1]
    return neuronops


def synops_device(fb_all_layer_outputs, sb_all_layer_outputs,
                  shared_weights: bool = True) -> torch.Tensor:
    """``compute_synops`` reduced on the spikes' device: one float64 scalar
    tensor crosses to the host instead of every layer's spikes. Each rate is
    an exact spike count over the element count, so the value is the host
    version's."""
    synops = None
    for cur, nxt in _layer_pairs(fb_all_layer_outputs, sb_all_layer_outputs):
        rate = (cur > 0).sum().double() / cur.numel()
        term = rate * cur.shape[-1] * (nxt.shape[-1] + cur.shape[-1])
        synops = term if synops is None else synops + term
    if synops is None:
        synops = torch.zeros((), dtype=torch.float64)
    return synops if shared_weights else 2 * synops
