"""Traffic mixes. A mix is a JSON file under ``traffic/``; its
``generator`` names a module ``generators/<generator>.py`` that makes a
batch from the mix's parameters and the run's seed. A new mix of an
existing shape is a new JSON file; a new shape (mixed lengths, say) is a new
generator file beside it. Nothing here changes for either.

Keys every mix has: ``mode`` (the runner, ``runners/<mode>.py``),
``generator``, ``sample_rate``, ``pool`` (distinct batches made at set-up
and cycled through) and ``check_rows`` (utterances a pool batch whose
outputs are compared); the generator's own keys are in its ``REQUIRED``.
``load`` adds ``generator_file``, the generator's path.

A generator's ``make_batch(spec, seed, index, device)`` returns ``noisy``
(``[batch, samples]``), ``clean`` and ``audio_s``, the audio-seconds the
batch holds (its utterances' own lengths, padding left out). ``noisy`` on
``device`` stays on the card; on the host (pinned) it stands for audio that
users hold there, and the runner copies it in and the answer out inside the
window.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Dict, List

import torch

REQUIRED = ("mode", "generator", "sample_rate", "pool", "check_rows")
_LOADED: Dict[str, Any] = {}


def generator(spec: Dict[str, Any]):
    """The module ``generators/<generator>.py`` beside the mix's folder."""
    path = spec["generator_file"]
    if path not in _LOADED:
        mod_spec = importlib.util.spec_from_file_location(
            f"gpubench_generator_{spec['generator']}_{len(_LOADED)}", path)
        mod = importlib.util.module_from_spec(mod_spec)
        mod_spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def load(path: Path) -> Dict[str, Any]:
    spec = json.loads(Path(path).read_text())
    if "generator" in spec:
        spec["generator_file"] = str(Path(path).parent.parent / "generators"
                                     / f"{spec['generator']}.py")
    missing = [k for k in REQUIRED if k not in spec]
    if not missing:
        missing = [k for k in generator(spec).REQUIRED if k not in spec]
    if missing:
        raise ValueError(f"{path}: traffic keys missing: {missing}")
    return spec


def make_pool(spec: Dict[str, Any], seed: int, device: torch.device) -> List[Dict[str, Any]]:
    """The ``pool`` distinct batches of a run."""
    gen = generator(spec)
    return [gen.make_batch(spec, seed, i, device) for i in range(spec["pool"])]
