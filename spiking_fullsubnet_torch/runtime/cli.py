"""The experiment CLI (counterpart of ``spiking_fullsubnet_tpu/runtime/cli.py``):

    python -m spiking_fullsubnet_torch.runtime.cli -C <recipe toml> \\
        -M train|validate|test|predict|finetune [-R] [--ckpt_path best|latest|init|<path>] \\
        [--device cuda|cpu]

The repo's recipe TOMLs load unchanged (their JAX-package paths resolve in
the port, ``registry.resolve``). Each recipe directory names its trainer in
a ``trainer.py`` that imports the JAX package, so the port never imports
it: ``RECIPE_TRAINERS`` maps the recipe directory (the TOML's own, unless
``main`` is given another) and the module its ``[trainer] path`` names to
the port's trainer. The weights live on ``--device``, ``cuda`` unless
``cpu`` is asked for.
"""

from __future__ import annotations

import argparse
import functools
from pathlib import Path

from ..data import DataLoader
from .config import toml_load
from .logging_ import init_logging_logger
from .registry import build_optimizer_factory, instantiate

# (recipes/<group>/<recipe>, the recipe module its [trainer] path names)
# -> the port's trainer class, by import path
DENOISE = "spiking_fullsubnet_torch.recipes.denoise.DenoiseTrainer"
RECIPE_TRAINERS = {
    ("intel_ndns", "spiking_fullsubnet", "trainer"): DENOISE,
    ("intel_ndns", "cirm_gsn", "trainer"): DENOISE,
    # the freeze phase's GanDenoiseTrainer runs the plain denoise loop when
    # the TOML configures no discriminator (recipes/gan.py:235-236)
    ("intel_ndns", "spiking_fullsubnet_freeze_phase", "trainer"): DENOISE,
}
NOT_PORTED = "ROADMAP queue 1: remaining models and recipes"


def trainer_class(recipe_dir, config):
    """The port's trainer for a recipe directory and its TOML."""
    key = (*Path(recipe_dir).resolve().parts[-2:], config["trainer"]["path"].rpartition(".")[0])
    if key not in RECIPE_TRAINERS:
        raise NotImplementedError(f"the recipe {'/'.join(key[:2])!r} with its {key[2]!r} "
                                  f"trainer is not ported yet ({NOT_PORTED})")
    if any(section.startswith("model_d") for section in config):
        raise NotImplementedError(f"the GAN trainer ([model_d*] sections) is not ported yet "
                                  f"({NOT_PORTED})")
    return instantiate(RECIPE_TRAINERS[key], initialize=False)


def _loaders(cfgs, **kw):
    if not isinstance(cfgs, list):
        cfgs = [cfgs]
    return [DataLoader(dataset=instantiate(c["path"], args=c["args"]), **kw,
                       **c.get("dataloader", {})) for c in cfgs]


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
        train_dataloader = _loaders(config["train_dataset"], shuffle=True, seed=seed)[0]
    if "train" in modes or "finetune" in modes or "validate" in modes:
        validate_dataloaders = _loaders(config["validate_dataset"])
    if "test" in modes or "predict" in modes:
        test_dataloaders = _loaders(config["test_dataset"])

    trainer = trainer_cls(config=config, resume=resume, model=model,
                          optimizer_factory=optimizer_factory, base_lr=base_lr,
                          loss_function=loss_function, device=device)
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
    parser.add_argument("--device", type=str, default="cuda",
                        help="Device of the weights and batches: cuda (default) or cpu.")
    args = parser.parse_args(argv)

    config_path = Path(args.configuration).expanduser().absolute()
    config = toml_load(config_path)
    config["meta"]["exp_id"] = config_path.stem
    config["meta"]["config_path"] = config_path.as_posix()
    if "test" in args.mode and args.ckpt_path is None:
        raise ValueError("checkpoint path is required for test. Use '--ckpt_path' "
                         "(best | latest | init | a path).")
    if args.ckpt_path:
        config["meta"]["ckpt_path"] = args.ckpt_path
    return run(config, args.resume, args.mode, args.ckpt_path,
               recipe_dir=recipe_dir or config_path.parent, device=args.device)


if __name__ == "__main__":
    main()
