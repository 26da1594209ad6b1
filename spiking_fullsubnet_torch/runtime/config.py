"""TOML experiment configuration (a copy of
``spiking_fullsubnet_tpu/runtime/config.py``; reference
audiozen/config_loader.py).

Loading uses stdlib tomllib; `$ENV_VAR` / `${ENV_VAR}` interpolation mirrors
config_loader.py:11-53. Since tomllib has no writer, a minimal writer is
included for the per-run config snapshot (trainer.py:105-106 behavior).
"""

from __future__ import annotations

import os
import re
import tomllib
from pathlib import Path
from typing import Any, Dict, Union

_ENV_PATTERN = re.compile(r"\$\{(\w+)\}|\$(\w+)")


def _interpolate(value):
    if isinstance(value, str):
        def repl(m):
            name = m.group(1) or m.group(2)
            if name in os.environ:
                return os.environ[name]
            return m.group(0)

        return _ENV_PATTERN.sub(repl, value)
    if isinstance(value, dict):
        return {k: _interpolate(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_interpolate(v) for v in value]
    return value


def toml_load(path: Union[str, Path], interpolate_env: bool = False) -> Dict[str, Any]:
    with open(path, "rb") as f:
        cfg = tomllib.load(f)
    return _interpolate(cfg) if interpolate_env else cfg


def toml_loads(text: str, interpolate_env: bool = False) -> Dict[str, Any]:
    cfg = tomllib.loads(text)
    return _interpolate(cfg) if interpolate_env else cfg


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_fmt_value(x) for x in v) + "]"
    raise TypeError(f"Cannot serialize {type(v)} to TOML")


def _is_table(v) -> bool:
    return isinstance(v, dict) or (isinstance(v, list) and bool(v) and isinstance(v[0], dict))


def _dump_table(d: Dict[str, Any], prefix: str, lines, header: bool = True):
    """``d`` under ``[prefix]`` (no header line where ``header`` is false: an
    item of an array of tables, whose ``[[prefix]]`` is already written).
    Two deviations from the JAX writer, so that every snapshot loads back:
    an empty table gets its header, and an item's sub-tables are prefixed
    with the array's name (``[test_dataset.args]``, where JAX writes
    ``[args]``)."""
    scalars = {k: v for k, v in d.items() if not _is_table(v)}
    if header and prefix and (scalars or not d):
        lines.append(f"[{prefix}]")
    for k, v in scalars.items():
        if v is None:
            continue
        lines.append(f"{k} = {_fmt_value(v)}")
    if scalars or (header and prefix and not d):
        lines.append("")
    for k, v in d.items():
        if isinstance(v, dict):
            _dump_table(v, f"{prefix}.{k}" if prefix else k, lines)
    for k, items in d.items():
        if isinstance(items, list) and _is_table(items):
            name = f"{prefix}.{k}" if prefix else k
            for item in items:
                lines.append(f"[[{name}]]")
                _dump_table(item, name, lines, header=False)


def toml_dump(config: Dict[str, Any], path: Union[str, Path]) -> None:
    lines: list = []
    _dump_table(config, "", lines)
    Path(path).write_text("\n".join(lines) + "\n")
