"""Weights for the port: the JAX package's ``.npz`` files and numpy pytrees.

Counterpart of ``spiking_fullsubnet_tpu/runtime/convert.py:135-160``. The
``.npz`` keys are ``/``-joined pytree paths (``params/sb/0/stack/layers/0/
weight_hh``); a level whose keys are all integers is a list. Arrays are
already in torch layout ``[rows, in]``: with shared weights ``weight_ih
[H, in]``, ``weight_hh [H, H]`` and ``bias_ih [2H]`` (b_f, then b_c).
No template is needed: the nesting comes from the keys themselves.
"""

from __future__ import annotations

from typing import Any, Dict

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
