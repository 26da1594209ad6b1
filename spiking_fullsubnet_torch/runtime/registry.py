"""Dynamic instantiation from dotted paths (counterpart of
``spiking_fullsubnet_tpu/runtime/registry.py``; reference
audiozen/utils.py:75-130).

Every pluggable component in a TOML is a {path, args} pair. The repo's
TOMLs name the JAX package: a path under ``spiking_fullsubnet_tpu.``
resolves to the same path under ``spiking_fullsubnet_torch.``, so they load
unchanged; every module of the JAX package has its counterpart. A path
into the Pallas module ``ops.gsu_pallas`` raises ``ImportError`` naming
its counterpart, ``ops/gsu_kernels.py``. Unlike the JAX registry, paths
do not resolve against the working directory: a recipe directory's own
modules import the JAX package (the CLI maps those it needs to the port's
copies, ``cli.RECIPE_MODULES``).
"""

from __future__ import annotations

import importlib
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

JAX_PREFIX, PORT_PREFIX = "spiking_fullsubnet_tpu.", "spiking_fullsubnet_torch."

# modules of the JAX package with no module of the same name in the port ->
# where their counterpart is. The Pallas module is replaced by
# ops/gsu_kernels (every kernel ported), whose wrappers take other
# arguments, so a path into it raises ImportError naming that file. Every
# other name of the package has its counterpart, so a name outside this
# table that the port lacks is unknown: it raises ImportError, as a missing
# name does in any package.
COUNTERPARTS: Dict[str, str] = {
    "ops.gsu_pallas": "spiking_fullsubnet_torch/ops/gsu_kernels.py",
}

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


def resolve(path: str):
    """Import ``pkg.module.Attr``; a JAX-package path resolves in the port."""
    if path.startswith(JAX_PREFIX):
        path = PORT_PREFIX + path.removeprefix(JAX_PREFIX)
    rel = path.removeprefix(PORT_PREFIX)
    for key, counterpart in COUNTERPARTS.items():
        if rel == key or rel.startswith(key + "."):
            raise ImportError(f"{path!r} has no module of that name in the port; its "
                              f"counterpart is {counterpart}")
    module_path, _, attr = path.rpartition(".")
    if not module_path:
        raise ImportError(f"Cannot resolve bare name {path!r}")
    module = importlib.import_module(module_path)
    if not hasattr(module, attr):
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
