"""The port's public imports against the JAX package's: every name that
JAX's re-exporting package ``__init__`` files (``dsp``, ``models``,
``recipes``, ``runtime``, ``native``) import is importable from the same
package of the port, is the port's own object, and comes from the
counterpart of the JAX submodule that defines it. Names that wait for a
later slice would be listed in ``LATER`` with their ROADMAP item; there are
none. The port's package ``__init__`` files resolve their names at first
use, so importing one module of a package does not import the rest.
"""

from __future__ import annotations

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("dsp", "models", "recipes", "runtime", "native")
LATER: tuple = ()  # (package, name, ROADMAP queue 1 item)


def _jax_exports(pkg):
    """(name, submodule) of every ``from .x import ...`` of the JAX
    package's ``__init__.py``, read from its source."""
    tree = ast.parse((ROOT / "spiking_fullsubnet_tpu" / pkg / "__init__.py").read_text())
    return [(a.asname or a.name, node.module) for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.level == 1 for a in node.names]


CASES = [(pkg, name, mod) for pkg in PACKAGES for name, mod in _jax_exports(pkg)]


def test_the_walk_sees_every_package():
    counts = {pkg: sum(1 for p, _, _ in CASES if p == pkg) for pkg in PACKAGES}
    assert counts == {"dsp": 42, "models": 23, "recipes": 7, "runtime": 22, "native": 5}


@pytest.mark.parametrize("pkg", PACKAGES)
def test_every_jax_name_imports_from_the_port(pkg):
    port = importlib.import_module(f"spiking_fullsubnet_torch.{pkg}")
    later = {name for p, name, _ in LATER if p == pkg}
    for p, name, mod in CASES:
        if p != pkg or name in later:
            continue
        obj = getattr(port, name)  # what `from spiking_fullsubnet_torch.<pkg> import name` reads
        sub = importlib.import_module(f"spiking_fullsubnet_torch.{pkg}.{mod}")
        assert obj is getattr(sub, name), (pkg, name, mod)
        assert name in getattr(port, "__all__", [name]), (pkg, name)
    assert not LATER


def test_unknown_name_raises_attribute_error():
    from spiking_fullsubnet_torch import dsp

    with pytest.raises(AttributeError, match="no attribute"):
        dsp.no_such_name  # noqa: B018
    assert "stft" in dir(dsp)


def test_one_module_does_not_import_its_package():
    code = ("import sys\nimport spiking_fullsubnet_torch.runtime.device\n"
            "import spiking_fullsubnet_torch.models.sequence_model\n"
            "heavy = [m for m in ('spiking_fullsubnet_torch.runtime.trainer', "
            "'spiking_fullsubnet_torch.recipes.denoise', "
            "'spiking_fullsubnet_torch.models.conv_tasnet') if m in sys.modules]\n"
            "assert not heavy, heavy\nprint('LAZY')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert "LAZY" in out.stdout, out.stdout + out.stderr
