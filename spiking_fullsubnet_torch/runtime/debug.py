"""Numerical sanitation for ``[trainer.args] debug = true`` (counterpart of
``spiking_fullsubnet_tpu/runtime/debug.py``; reference
audiozen/debug_utils.py)."""

from __future__ import annotations

import logging

import torch

logger = logging.getLogger(__name__)


def enable_debug_nans(enable: bool = True) -> None:
    """Raise where a backward produces NaN (autograd's anomaly mode: the
    counterpart of ``jax_debug_nans``)."""
    torch.autograd.set_detect_anomaly(enable)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}" if path else str(i))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def detect_overflow(tree, tag: str = "") -> bool:
    """Finite check of every tensor of a nested dict/list tree; logs the
    offending leaf paths. Returns True if any leaf is non-finite
    (detect_overflow, debug_utils.py:282-324)."""
    bad = False
    for path, leaf in _leaves(tree):
        leaf = leaf.detach()
        if not bool(torch.isfinite(leaf).all()):
            logger.error(f"{tag} non-finite values in {path}: "
                         f"nan={int(torch.isnan(leaf).sum())}, inf={int(torch.isinf(leaf).sum())}")
            bad = True
    return bad
