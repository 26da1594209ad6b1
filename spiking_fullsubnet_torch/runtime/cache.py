"""Where the kernels' libraries are built (counterpart of
``spiking_fullsubnet_tpu/runtime/cache.py``, the JAX package's persistent
compilation cache).

nvcc builds each kernel library once into ``ops/gsu_kernels.BUILD_DIR``
(the package's ``_build/`` unless moved here). A library's name hashes its
sources and flags (``gsu_kernels._lib_path``), so a directory kept across
processes is a cache: a process whose sources match finds its libraries
built, and one whose sources differ builds beside them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union


def enable_compilation_cache(path: Optional[Union[str, Path]] = None) -> Path:
    """Build and load the kernel libraries from ``path`` (created if
    missing); ``None`` keeps or restores the package's ``_build/``. A
    library already loaded in this process keeps its handle. Returns the
    directory."""
    from ..ops import gsu_kernels

    build = Path(path) if path is not None else gsu_kernels.DEFAULT_BUILD_DIR
    build.mkdir(parents=True, exist_ok=True)
    gsu_kernels.BUILD_DIR = build
    return build
