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


def _dump_table(d: Dict[str, Any], prefix: str, lines):
    scalars = {k: v for k, v in d.items() if not isinstance(v, (dict, list)) or (
        isinstance(v, list) and not (v and isinstance(v[0], dict)))}
    tables = {k: v for k, v in d.items() if isinstance(v, dict)}
    array_tables = {
        k: v for k, v in d.items() if isinstance(v, list) and v and isinstance(v[0], dict)
    }
    if prefix and scalars:
        lines.append(f"[{prefix}]")
    for k, v in scalars.items():
        if v is None:
            continue
        lines.append(f"{k} = {_fmt_value(v)}")
    if scalars:
        lines.append("")
    for k, v in tables.items():
        _dump_table(v, f"{prefix}.{k}" if prefix else k, lines)
    for k, items in array_tables.items():
        for item in items:
            lines.append(f"[[{prefix + '.' if prefix else ''}{k}]]")
            sub = []
            _dump_table(item, "", sub)
            lines.extend(sub)


def toml_dump(config: Dict[str, Any], path: Union[str, Path]) -> None:
    lines: list = []
    _dump_table(config, "", lines)
    Path(path).write_text("\n".join(lines) + "\n")
