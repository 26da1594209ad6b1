"""Numerical sanitation for ``[trainer.args] debug = true`` (counterpart of
``spiking_fullsubnet_tpu/runtime/debug.py``; reference
audiozen/debug_utils.py), and the per-module activation tracer
(``nn/module_tracer.py``) re-exported, so that the debug tools have one
import surface."""

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


def clamp_inf_value(x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Clamp +-inf to ``dtype``'s largest and smallest finite values, NaN to
    0 (reference utils.py:167-172; ``debug.py:44-48``)."""
    fi = torch.finfo(dtype)
    return torch.clamp(torch.nan_to_num(x, posinf=fi.max, neginf=fi.min), fi.min, fi.max)


from ..nn.module_tracer import (  # noqa: E402,F401
    ActivationTracer,
    FloatingPointAbort,
    module_scope,
    trace_activation,
)
