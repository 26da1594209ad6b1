"""Weights for the port: the reference's torch checkpoints, the JAX
package's ``.npz`` files and numpy pytrees (counterpart of
``spiking_fullsubnet_tpu/runtime/convert.py``).

The reference's parameter names, both generations, map onto the port's
param/state trees (``import_spiking_fullsubnet``):

- latest (audiozen SpikingFullSubNet): ``fb_model.pre_layer_norm.*``,
  ``fb_model.sequence_model.layers.{i}.cell.*``, ``fb_model.proj.*``,
  ``sb_model.sb_models.{k}.*``;
- frozen (the competition Separator): the same cells, the projection named
  ``fc_output_layer`` and no pre-LayerNorm.

``reference_state_dict`` writes a tree back under those names.

The ``.npz`` keys are ``/``-joined tree paths (``params/sb/0/stack/layers/
0/weight_hh``); a level whose keys are all integers is a list. Arrays are
already in torch layout ``[rows, in]``: with shared weights ``weight_ih
[H, in]``, ``weight_hh [H, H]`` and ``bias_ih [2H]`` (b_f, then b_c).
No template is needed: the nesting comes from the keys themselves.
``save_npz`` writes the keys that this module's and the JAX package's
``load_npz`` read.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .device import resolve_device


def _nest(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return _lists(root)


def _lists(node):
    """Turn every dict whose keys are 0..n-1 into a list (pytree lists)."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        idx = sorted(int(k) for k in node)
        if idx == list(range(len(idx))):
            return [node[str(i)] for i in idx]
    return node


def params_from_numpy(tree, device=None):
    """Numpy pytree (dicts/lists of arrays, e.g. the JAX package's params or
    state after ``np.asarray``) -> the same nesting of tensors, each in its
    array's dtype, on ``device``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, copy=True)).to(dev)

    return conv(tree)


def load_npz(path: str, device=None) -> Dict[str, Any]:
    """Read an ``.npz`` written by the JAX package's ``save_npz`` into nested
    dicts/lists of tensors (for the zoo files: ``{"params": ..., "state": ...}``)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_numpy(_nest(flat), device=device)


def load_torch_state_dict(path: str, device=None) -> Dict[str, torch.Tensor]:
    """A torch ``.bin``/``.pt`` checkpoint as a flat dict of tensors on
    ``device`` (default ``cuda``): a pickled module, ``{"state_dict": ...}``
    or a flat state dict, as the JAX package's loader takes them."""
    dev = resolve_device(device)
    obj = torch.load(path, map_location=dev, weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    return {k: v.detach() for k, v in obj.items() if hasattr(v, "detach")}


def _strip_module(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Keys without DDP's leading ``module.`` (Accelerate's checkpoints)."""
    return {k.removeprefix("module."): v for k, v in sd.items()}


def _seq_model_from_sd(sd: Mapping[str, torch.Tensor], prefix: str, num_layers: int, bn: bool):
    """One sequence model's (params, state) from the reference names under
    ``prefix`` (``convert.py:39-84``)."""
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {"stack": {"layers": [{} for _ in range(num_layers)]}}
    if f"{prefix}.pre_layer_norm.weight" in sd:
        params["pre_ln"] = {"weight": sd[f"{prefix}.pre_layer_norm.weight"],
                            "bias": sd[f"{prefix}.pre_layer_norm.bias"]}
    layers = []
    for i in range(num_layers):
        cp = f"{prefix}.sequence_model.layers.{i}.cell"
        layer = {k: sd[f"{cp}.{k}"] for k in ("weight_ih", "weight_hh", "bias_ih")}
        if bn:
            layer["bn"] = {k: sd[f"{cp}.batchnorm.{k}"] for k in ("weight", "bias")}
            state["stack"]["layers"][i]["bn"] = {
                k: sd[f"{cp}.batchnorm.{k}"] for k in ("running_mean", "running_var")}
        layers.append(layer)
    params["stack"] = {"layers": layers}
    for proj_name in ("proj", "fc_output_layer"):
        if f"{prefix}.{proj_name}.weight" in sd:
            params["proj"] = {k: sd[f"{prefix}.{proj_name}.{k}"] for k in ("weight", "bias")}
            break
    return params, state


def import_spiking_fullsubnet(sd: Mapping[str, torch.Tensor], cfg):
    """Reference state dict -> ``(params, state)`` for
    ``spiking_fullsubnet_apply``, the tensors on the state dict's device.
    Takes both generations' checkpoints, with or without the ``module.``
    prefix (``convert.py:86-97``)."""
    sd = _strip_module(sd)
    fb_params, fb_state = _seq_model_from_sd(sd, "fb_model", cfg.fb_num_layers, cfg.bn)
    sb_params, sb_states = [], []
    for k in range(cfg.num_sections):
        p, s = _seq_model_from_sd(sd, f"sb_model.sb_models.{k}", cfg.sb_num_layers, cfg.bn)
        sb_params.append(p)
        sb_states.append(s)
    return {"fb": fb_params, "sb": sb_params}, {"fb": fb_state, "sb": sb_states}


def reference_state_dict(params, state, generation: str = "frozen", prefix: str = "module."
                         ) -> Dict[str, torch.Tensor]:
    """``import_spiking_fullsubnet`` read backwards: the weights under the
    reference's key names, each a detached copy on the CPU. ``generation``
    "frozen" names the projection ``fc_output_layer`` (the Separator's,
    whose configs have no pre-LayerNorm); "latest" names it ``proj``. A
    pre-LayerNorm goes out where the params hold one. ``prefix`` is DDP's
    ``module.`` (Accelerate's checkpoints) or ``""``."""
    sd = {}

    def seq(p, st, name):
        if "pre_ln" in p:
            for k in ("weight", "bias"):
                sd[f"{name}.pre_layer_norm.{k}"] = p["pre_ln"][k]
        for i, (lp, ls) in enumerate(zip(p["stack"]["layers"], st["stack"]["layers"])):
            cp = f"{name}.sequence_model.layers.{i}.cell"
            for k in ("weight_ih", "weight_hh", "bias_ih"):
                sd[f"{cp}.{k}"] = lp[k]
            if "bn" in lp:
                for k in ("weight", "bias"):
                    sd[f"{cp}.batchnorm.{k}"] = lp["bn"][k]
                for k in ("running_mean", "running_var"):
                    sd[f"{cp}.batchnorm.{k}"] = ls["bn"][k]
        proj = "fc_output_layer" if generation == "frozen" else "proj"
        for k in ("weight", "bias"):
            sd[f"{name}.{proj}.{k}"] = p["proj"][k]

    seq(params["fb"], state["fb"], "fb_model")
    for i, (p, st) in enumerate(zip(params["sb"], state["sb"])):
        seq(p, st, f"sb_model.sb_models.{i}")
    return {prefix + k: v.detach().cpu().clone() for k, v in sd.items()}


def import_discriminator(sd: Mapping[str, torch.Tensor], ndf: int = 16):
    """Reference Discriminator state dict -> ``discriminator_apply`` params
    (``convert.py:100-132``; ``ndf`` as in its signature, the shapes come
    from the state dict): the spectral-norm names ``weight_orig``,
    ``weight_u``, ``weight_v``; the layer indices of the reference's
    ``nn.Sequential`` (4 x [Conv2d, InstanceNorm2d, PReLU] at 0-11, fc1 at
    14, PReLU at 16, fc2 at 17, LearnableSigmoid at 18)."""
    sd = _strip_module(sd)

    def spectral(idx: int, bias: bool):
        out = {"weight": sd[f"layers.{idx}.weight_orig"]}
        if bias:
            out["bias"] = sd[f"layers.{idx}.bias"]
        return dict(out, u=sd[f"layers.{idx}.weight_u"], v=sd[f"layers.{idx}.weight_v"])

    return {
        "convs": [spectral(3 * j, bias=False) for j in range(4)],
        "inorm": [{k: sd[f"layers.{3 * j + 1}.{k}"] for k in ("weight", "bias")}
                  for j in range(4)],
        "prelu": [sd[f"layers.{3 * j + 2}.weight"] for j in range(4)],
        "fc1": spectral(14, bias=True),
        "prelu_fc": sd["layers.16.weight"],
        "fc2": spectral(17, bias=True),
        "sigmoid_slope": sd["layers.18.slope"],
    }


def flat_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """The leaves of a dict/list tree by ``/``-joined path."""
    if isinstance(tree, dict):
        return {k2: v for k, x in tree.items() for k2, v in flat_paths(x, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, x in enumerate(tree)
                for k2, v in flat_paths(x, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def save_npz(path: str, tree) -> None:
    """A dict/list tree of tensors or arrays as an ``.npz`` keyed by the
    ``/``-joined paths (the reload format of both packages' ``load_npz``)."""
    np.savez(path, **{k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v)) for k, v in flat_paths(tree).items()})
