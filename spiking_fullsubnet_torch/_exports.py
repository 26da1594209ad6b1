"""Lazy re-exports for the port's package ``__init__`` files: the names the
JAX package's ``__init__`` files import eagerly resolve here at first use,
from the submodule that defines them, so that importing one module of a
package does not import the whole package (the runtime's and the recipes'
names reach the trainers, which import the models)."""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List, Tuple


def lazy_exports(package: str, table: Dict[str, str]
                 ) -> Tuple[Callable[[str], object], Callable[[], List[str]]]:
    """``(__getattr__, __dir__)`` for ``package`` whose names ``table`` maps
    to the submodule (relative to the package) that defines each."""
    def __getattr__(name: str):
        if name not in table:
            raise AttributeError(f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(f"{package}.{table[name]}"), name)
        setattr(importlib.import_module(package), name, value)
        return value

    def __dir__() -> List[str]:
        return sorted(set(table) | set(vars(importlib.import_module(package))))

    return __getattr__, __dir__


def table_of(groups: Dict[str, Tuple[str, ...]]) -> Dict[str, str]:
    """{submodule: names} -> {name: submodule}."""
    return {name: mod for mod, names in groups.items() for name in names}
