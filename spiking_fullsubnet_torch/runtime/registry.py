"""Dynamic instantiation from dotted paths (counterpart of
``spiking_fullsubnet_tpu/runtime/registry.py``; reference
audiozen/utils.py:75-130).

Every pluggable component in a TOML is a {path, args} pair. The repo's
TOMLs name the JAX package: a path under ``spiking_fullsubnet_tpu.``
resolves to the same path under ``spiking_fullsubnet_torch.``, so they load
unchanged. A path with no port yet raises ``NotImplementedError`` naming,
by title, the ROADMAP item that brings it. Unlike the JAX registry, paths
do not resolve against the working directory: a recipe directory's own
modules import the JAX package (the CLI maps those it needs to the port's
copies, ``cli.RECIPE_MODULES``).
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

JAX_PREFIX, PORT_PREFIX = "spiking_fullsubnet_tpu.", "spiking_fullsubnet_torch."

# modules of the JAX package not ported yet -> the ROADMAP queue 1 item
# that brings them. The Pallas module itself is replaced by ops/gsu_kernels
# (every kernel ported); the root tools that drive it come with "the data and
# metric tools". Any other unported name: the last slice of the package,
# "band-parallel sub-bands".
ROADMAP_ITEMS: Dict[str, str] = {
    "ops.gsu_pallas": "the data and metric tools",
    "parallel.mesh": "band-parallel sub-bands",
    "parallel.make_mesh": "band-parallel sub-bands",
    "parallel.batch_sharding": "band-parallel sub-bands",
    "parallel.shard_batch": "band-parallel sub-bands",
    "parallel.current_axis_size": "band-parallel sub-bands",
    "runtime.timing": "bench on the GPU",
    "runtime.roofline": "bench on the GPU",
    "runtime.cache": "bench on the GPU",
}
_DEFAULT_ITEM = "band-parallel sub-bands"

# optimizer paths -> (torch.optim class, the TOML args it takes with the
# defaults of the JAX registry's optax factories, registry.py:20-30)
OPTIMIZERS: Dict[str, Tuple[type, Dict[str, Any]]] = {
    "torch.optim.AdamW": (torch.optim.AdamW,
                          {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-2}),
    "torch.optim.Adam": (torch.optim.Adam, {"betas": (0.9, 0.999), "eps": 1e-8}),
    "torch.optim.SGD": (torch.optim.SGD, {"momentum": 0.0}),
}
OPTIMIZERS.update({"optax.adamw": OPTIMIZERS["torch.optim.AdamW"],
                   "optax.adam": OPTIMIZERS["torch.optim.Adam"],
                   "optax.sgd": OPTIMIZERS["torch.optim.SGD"]})

# Loss-function aliases for reference TOML compatibility.
LOSS_ALIASES: Dict[str, str] = {
    "torch.nn.MSELoss": "spiking_fullsubnet_torch.losses.mse_loss",
    "torch.nn.L1Loss": "spiking_fullsubnet_torch.losses.l1_loss",
    "audiozen.loss.SISNRLoss": "spiking_fullsubnet_torch.losses.si_snr_loss",
}


def roadmap_item(path: str) -> str:
    """The ROADMAP queue 1 item, by title, that ports ``path`` (a module or
    an attribute of the port, ``spiking_fullsubnet_torch.x.y``)."""
    rel = path.removeprefix(PORT_PREFIX)
    for key, title in ROADMAP_ITEMS.items():
        if rel == key or rel.startswith(key + "."):
            return title
    return _DEFAULT_ITEM


def resolve(path: str):
    """Import ``pkg.module.Attr``; a JAX-package path resolves in the port."""
    if path.startswith(JAX_PREFIX):
        path = PORT_PREFIX + path.removeprefix(JAX_PREFIX)
    module_path, _, attr = path.rpartition(".")
    if not module_path:
        raise ImportError(f"Cannot resolve bare name {path!r}")
    try:
        module = importlib.import_module(module_path)
    except ModuleNotFoundError as e:
        if not (e.name or "").startswith(PORT_PREFIX):
            raise
        raise NotImplementedError(
            f"{path!r} is not ported yet (ROADMAP queue 1: {roadmap_item(e.name)})") from e
    if not hasattr(module, attr):
        if module_path.startswith(PORT_PREFIX):
            raise NotImplementedError(
                f"{path!r} is not ported yet (ROADMAP queue 1: {roadmap_item(path)})")
        raise ImportError(f"Module {module_path!r} has no attribute {attr!r}")
    return getattr(module, attr)


def instantiate(path: str, args: Optional[Dict[str, Any]] = None, initialize: bool = True):
    """Reference-compatible instantiate (utils.py:75-130)."""
    obj = resolve(LOSS_ALIASES.get(path, path))
    if initialize:
        return obj(**(args or {}))
    return obj


def build_optimizer_factory(path: str, args: Dict[str, Any]
                            ) -> Tuple[Callable[[Iterable[torch.Tensor]], torch.optim.Optimizer],
                                       float]:
    """Returns (factory(params) -> torch optimizer over ``params``, base_lr).

    The factory's optimizer takes the TOML's values for the arguments the
    JAX registry passes to optax and its defaults for the rest; the
    trainer sets each update's learning rate from its schedule."""
    if path not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer {path!r} is not mapped; the port maps "
                                  f"{sorted(OPTIMIZERS)}")
    args = dict(args or {})
    lr = args.pop("lr", args.pop("learning_rate", 1e-3))
    cls, defaults = OPTIMIZERS[path]
    kw = {k: args.get(k, v) for k, v in defaults.items()}
    if "betas" in kw:
        kw["betas"] = tuple(kw["betas"])

    def factory(params: Iterable[torch.Tensor]) -> torch.optim.Optimizer:
        return cls(list(params), lr=lr, **kw)

    return factory, lr
