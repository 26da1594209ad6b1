"""The experiment CLI (counterpart of ``spiking_fullsubnet_tpu/runtime/cli.py``):

    python -m spiking_fullsubnet_torch.runtime.cli -C <recipe toml> \\
        -M train|validate|test|predict|finetune [-R] [--ckpt_path best|latest|init|<path>] \\
        [--torch_ckpt <reference pytorch_model.bin>] [--device cuda|cpu]

The repo's recipe TOMLs load unchanged (their JAX-package paths resolve in
the port, ``registry.resolve``). Each recipe directory names its trainer in
a ``trainer.py`` that imports the JAX package, so the port never imports
it: ``RECIPE_TRAINERS`` maps the recipe directory (the TOML's own, unless
``main`` is given another) and the module its ``[trainer] path`` names to
the port's trainer. A dataset path relative to the recipe directory
(``dataloader.SimTrainDataset``) names that directory's own module, which
imports the JAX package too: ``RECIPE_MODULES`` maps it to the port's copy.
A GAN trainer also gets the discriminators of the TOML's ``[model_d*]``
sections. The weights live on ``--device``, ``cuda``
unless ``cpu`` is asked for. ``--torch_ckpt`` (or ``[meta] torch_ckpt``)
imports a reference checkpoint (``runtime/convert.py``) into the model
before any mode runs; test, predict and finetune then use it where no
checkpoint of the experiment exists.
"""

from __future__ import annotations

import argparse
import functools
from pathlib import Path

from ..data import DataLoader
from ..recipes.gan import GanDenoiseTrainer, build_discriminator_bundles
from .config import toml_load
from .convert import import_spiking_fullsubnet, load_torch_state_dict
from .logging_ import init_logging_logger
from .registry import build_optimizer_factory, instantiate

# (recipes/<group>/<recipe>, the recipe module its [trainer] path names)
# -> the port's trainer class, by import path
DENOISE = "spiking_fullsubnet_torch.recipes.denoise.DenoiseTrainer"
GAN = "spiking_fullsubnet_torch.recipes.gan."
SEPARATION = "spiking_fullsubnet_torch.recipes.separation.SeparationTrainer"
FREEZE = ("intel_ndns", "spiking_fullsubnet_freeze_phase")
RECIPE_TRAINERS = {
    ("intel_ndns", "spiking_fullsubnet", "trainer"): DENOISE,
    ("intel_ndns", "spiking_fullsubnet", "trainer_GAN"): GAN + "GanDenoiseTrainer",
    ("intel_ndns", "cirm_gsn", "trainer"): DENOISE,
    # the freeze phase's GanDenoiseTrainer runs the plain denoise loop when
    # the TOML configures no discriminator (recipes/gan.py:235-236)
    (*FREEZE, "trainer"): GAN + "GanDenoiseTrainer",
    (*FREEZE, "trainer_dualGAN"): GAN + "DualGanDenoiseTrainer",
    (*FREEZE, "trainer_onlyGen"): GAN + "OnlyGenTrainer",
    ("wsj0-mix", "spiking_fullsubnet", "trainer"): SEPARATION,
    ("wsj0-mix", "conv_tasnet", "trainer"): SEPARATION,
    ("wsj0-mix", "cirm_lstm", "trainer"): SEPARATION,
    ("reverb", "spiking_fullsubnet", "trainer"): "spiking_fullsubnet_torch.recipes.dereverb."
                                                 "DereverbTrainer",
}
# (recipes/<group>/<recipe>, a module of that directory a TOML path names)
# -> the port's copy of the module
RECIPE_MODULES = {
    ("reverb", "spiking_fullsubnet", "dataloader"): "spiking_fullsubnet_torch.recipes.reverb_data",
}
NOT_PORTED = "ROADMAP queue 1: remaining models and recipes"


def _recipe_key(recipe_dir):
    return tuple(Path(recipe_dir).resolve().parts[-2:])


def trainer_class(recipe_dir, config):
    """The port's trainer for a recipe directory and its TOML."""
    key = (*_recipe_key(recipe_dir), config["trainer"]["path"].rpartition(".")[0])
    if key not in RECIPE_TRAINERS:
        raise NotImplementedError(f"the recipe {'/'.join(key[:2])!r} with its {key[2]!r} "
                                  f"trainer is not ported yet ({NOT_PORTED})")
    return instantiate(RECIPE_TRAINERS[key], initialize=False)


def recipe_path(path: str, recipe_dir=None) -> str:
    """``path`` with a module relative to the recipe directory (no package:
    ``dataloader.SimTrainDataset``) replaced by the port's copy of that
    module (``RECIPE_MODULES``); other paths as they are."""
    module, _, attr = path.rpartition(".")
    if "." in module or not module:
        return path
    key = (*_recipe_key(recipe_dir or "."), module)
    if key not in RECIPE_MODULES:
        raise NotImplementedError(f"{path!r} of the recipe {'/'.join(key[:2])!r} is not ported "
                                  f"yet ({NOT_PORTED})")
    return f"{RECIPE_MODULES[key]}.{attr}"


def _loaders(cfgs, recipe_dir=None, **kw):
    if not isinstance(cfgs, list):
        cfgs = [cfgs]
    return [DataLoader(dataset=instantiate(recipe_path(c["path"], recipe_dir), args=c["args"]),
                       **kw, **c.get("dataloader", {})) for c in cfgs]


def run(config, resume, modes, ckpt_path=None, recipe_dir=None, device=None):
    """Build the model, optimizer, loaders and trainer of ``config`` and run
    ``modes`` in order; returns the trainer."""
    trainer_cls = trainer_class(recipe_dir, config)
    init_logging_logger(config)
    seed = config["meta"].get("seed", 0)
    # the freeze-phase reference names its sections [model_g]/[optimizer_g]
    model_cfg = config.get("model") or config["model_g"]
    optim_cfg = config.get("optimizer") or config["optimizer_g"]
    model = instantiate(model_cfg["path"],
                        args={"seed": seed, "device": device} | model_cfg["args"])
    optimizer_factory, base_lr = build_optimizer_factory(optim_cfg["path"], optim_cfg["args"])

    loss_function = None
    if config.get("loss_function", {}).get("path"):
        # the port's losses are functions: the TOML's args are bound, not called
        loss_function = functools.partial(
            instantiate(config["loss_function"]["path"], initialize=False),
            **(config["loss_function"].get("args") or {}))

    train_dataloader = validate_dataloaders = test_dataloaders = None
    if "train" in modes or "finetune" in modes:
        train_dataloader = _loaders(config["train_dataset"], recipe_dir, shuffle=True,
                                    seed=seed)[0]
    if "train" in modes or "finetune" in modes or "validate" in modes:
        validate_dataloaders = _loaders(config["validate_dataset"], recipe_dir)
    if "test" in modes or "predict" in modes:
        test_dataloaders = _loaders(config["test_dataset"], recipe_dir)

    extra = {}
    if issubclass(trainer_cls, GanDenoiseTrainer):
        # the discriminators of [model_d*], as run_GAN.py and run_dualGAN.py
        # pass them through extra_trainer_kwargs
        extra = build_discriminator_bundles(config, seed, device)
    trainer = trainer_cls(config=config, resume=resume, model=model,
                          optimizer_factory=optimizer_factory, base_lr=base_lr,
                          loss_function=loss_function, device=device, **extra)
    torch_ckpt = config["meta"].get("torch_ckpt")
    if torch_ckpt:
        sd = load_torch_state_dict(torch_ckpt, device)
        trainer.preload_weights(*import_spiking_fullsubnet(sd, trainer.model_config))
    ckpt_path = ckpt_path or config["meta"].get("ckpt_path", "best")
    try:
        for flag in modes:
            if flag == "train":
                trainer.train(train_dataloader, validate_dataloaders)
            elif flag == "validate":
                trainer.validate(validate_dataloaders)
            elif flag == "test":
                trainer.test(test_dataloaders, ckpt_path)
            elif flag == "predict":
                trainer.predict(test_dataloaders, ckpt_path)
            elif flag == "finetune":
                trainer.finetune(train_dataloader, validate_dataloaders, ckpt_path)
            else:
                raise ValueError(f"Unknown mode: {flag}.")
    finally:
        trainer.close()
    return trainer


def main(argv=None, recipe_dir=None):
    """Parse ``argv`` and ``run``. ``recipe_dir`` names the recipe directory
    whose trainer runs (default: the TOML's own directory)."""
    parser = argparse.ArgumentParser(description="Spiking-FullSubNet, PyTorch port")
    parser.add_argument("-C", "--configuration", required=True, type=str,
                        help="Configuration (*.toml).")
    parser.add_argument("-M", "--mode", nargs="+", type=str, default=["train"],
                        choices=["train", "validate", "test", "predict", "finetune"],
                        help="Mode of the experiment.")
    parser.add_argument("-R", "--resume", action="store_true",
                        help="Resume from the latest checkpoint.")
    parser.add_argument("--ckpt_path", type=str, default=None,
                        help="Checkpoint for test/predict/finetune: 'best', 'latest', 'init' or a "
                             "path.")
    parser.add_argument("--torch_ckpt", type=str, default=None,
                        help="Import a reference torch checkpoint (pytorch_model.bin) before "
                             "running.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device of the weights and batches: cuda (default) or cpu.")
    args = parser.parse_args(argv)

    config_path = Path(args.configuration).expanduser().absolute()
    config = toml_load(config_path)
    config["meta"]["exp_id"] = config_path.stem
    config["meta"]["config_path"] = config_path.as_posix()
    if "test" in args.mode and args.ckpt_path is None and args.torch_ckpt is None:
        raise ValueError("checkpoint path is required for test. Use '--ckpt_path' "
                         "(best | latest | init | a path).")
    if args.ckpt_path:
        config["meta"]["ckpt_path"] = args.ckpt_path
    if args.torch_ckpt:
        config["meta"]["torch_ckpt"] = args.torch_ckpt
    return run(config, args.resume, args.mode, args.ckpt_path,
               recipe_dir=recipe_dir or config_path.parent, device=args.device)


if __name__ == "__main__":
    main()
