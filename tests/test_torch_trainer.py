"""The port's recipe trainer and CLI on the CPU.

- End to end (tests/test_trainer_e2e.py's scenario) through
  ``runtime.cli.main --device cpu`` on the Spiking-FullSubNet and cIRM-GSN
  ``tiny_synthetic.toml`` recipes: the exp layout, the checkpoints, the
  metrics CSVs, ``-R`` restoring the counters, ``-M test --ckpt_path
  best``, predict and finetune.
- Parity with the JAX ``Trainer`` over one epoch of the Spiking-FullSubNet
  tiny recipe from the same initial weights (JAX's init, carried across),
  with gradient accumulation 1 and 2: the first update's loss dict and
  gradient norm within rtol 1e-5 in float32, every update's learning rate
  equal, the later losses and the validation SI-SDR within rtol 1e-3.
- ``max_steps`` stopping at exactly that many updates, and the refusals:
  the default device without a GPU and an unknown recipe trainer; the
  fused flagship recipe validating on the CPU, and the GAN, separation and
  sdnn_delays recipes' trainers.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from spiking_fullsubnet_tpu.data import DataLoader as JaxLoader
from spiking_fullsubnet_tpu.recipes import DenoiseTrainer as JaxDenoiseTrainer
from spiking_fullsubnet_tpu.runtime.registry import (build_optimizer_factory as jax_optimizer,
                                                     instantiate as jax_instantiate)

from spiking_fullsubnet_torch.data import DataLoader
from spiking_fullsubnet_torch.recipes.denoise import DenoiseTrainer
from spiking_fullsubnet_torch.runtime import cli
from spiking_fullsubnet_torch.runtime.config import toml_dump, toml_load
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy
from spiking_fullsubnet_torch.runtime.registry import build_optimizer_factory, instantiate

RECIPES = Path(__file__).resolve().parent.parent / "recipes"
SFS = RECIPES / "intel_ndns" / "spiking_fullsubnet"
CIRM = RECIPES / "intel_ndns" / "cirm_gsn"


def _cli(recipe_dir, *argv):
    return cli.main(["-C", "tiny_synthetic.toml", *argv, "--device", "cpu"],
                    recipe_dir=recipe_dir)


def _mean_csv_header(exp, epoch):
    csvs = sorted((exp / "metrics").glob(f"dl_0_epoch_{epoch}_*_mean.csv"))
    assert csvs
    return csvs[-1].read_text().splitlines()[0].split(",")


@pytest.mark.parametrize("recipe_dir,epochs,collects", [(SFS, 2, True), (CIRM, 1, False)],
                         ids=["spiking_fullsubnet", "cirm_gsn"])
def test_cli_train_resume_test_predict_finetune(recipe_dir, epochs, collects, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    shutil.copy(recipe_dir / "tiny_synthetic.toml", tmp_path / "tiny_synthetic.toml")
    t = _cli(recipe_dir, "-M", "train")
    assert type(t) is DenoiseTrainer
    assert t.state.epochs_trained == epochs
    exp = tmp_path / "exp" / "tiny_synthetic"
    for d in ("checkpoints", "tb_log", "enhanced", "metrics"):
        assert (exp / d).is_dir()
    assert list(exp.glob("config__*.toml")) and list(exp.glob("tiny_synthetic_*.log"))
    ckpts = sorted(p.name for p in (exp / "checkpoints").iterdir())
    assert ckpts == ["best"] + [f"epoch_{e:04d}" for e in range(1, epochs + 1)]
    assert (exp / "checkpoints" / "best" / "arrays.pt").exists()
    header = _mean_csv_header(exp, epochs)
    assert header[:2] == ["si_sdr", "stoi"]
    # the neuromorphic cost proxies of a forward that collects its spikes
    assert ("synops" in header and "neuron_ops" in header) == collects
    assert np.isfinite(t.state.best_score) and t.state.best_score > -100
    best = t.state.best_score

    # resume: the counters come back and max_epochs is reached already
    t2 = _cli(recipe_dir, "-M", "train", "-R")
    assert t2.state.epochs_trained == epochs and t2.state.steps_trained == t.state.steps_trained

    t3 = _cli(recipe_dir, "-M", "test", "--ckpt_path", "best")
    assert t3.state.epochs_trained == t.state.best_score_epoch
    with pytest.raises(ValueError, match="checkpoint path is required"):
        _cli(recipe_dir, "-M", "test")

    _cli(recipe_dir, "-M", "predict", "--ckpt_path", "latest")
    wavs = sorted((exp / "enhanced" / "dataloader_0").glob("*.wav"))
    assert [w.name for w in wavs] == ["synthetic_0.wav", "synthetic_1.wav"][:len(wavs)]
    assert wavs

    t4 = _cli(recipe_dir, "-M", "finetune", "--ckpt_path", "best")
    assert t4.state.epochs_trained == epochs
    assert (exp / "checkpoints_finetune" / "best").exists()
    assert t.state.best_score == best  # the base run's best is untouched


def _parity_config(tmp_path, accum):
    cfg = toml_load(SFS / "tiny_synthetic.toml")
    cfg["meta"]["exp_id"] = "parity"
    args = cfg["trainer"]["args"]
    args.update(max_epochs=1, gradient_accumulation_steps=accum, plot_lr=True,
                scheduler_name="linear_schedule_with_warmup", warmup_steps=2)
    cfg["train_dataset"]["args"]["num_samples"] = 16  # four batches: a varied learning rate
    return cfg


class _PortRecorder(DenoiseTrainer):
    def _log_step(self, grad_norm, lr):
        self.rec.setdefault("norms", []).append(float(grad_norm))
        self.rec.setdefault("lrs", []).append(lr)
        super()._log_step(grad_norm, lr)

    def training_epoch_end(self, out):
        self.rec.setdefault("losses", []).extend(out)
        super().training_epoch_end(out)


class _JaxRecorder(JaxDenoiseTrainer):
    def _log_step(self, loss_dict, grad_norm):
        self.rec.setdefault("norms", []).append(float(grad_norm))
        super()._log_step(loss_dict, grad_norm)

    def training_epoch_end(self, out):
        self.rec.setdefault("losses", []).extend(out)
        super().training_epoch_end(out)


def _loaders(cls, cfg):
    inst = jax_instantiate if cls is JaxLoader else instantiate
    train = cls(inst(cfg["train_dataset"]["path"], cfg["train_dataset"]["args"]), shuffle=True,
                seed=cfg["meta"]["seed"], **cfg["train_dataset"]["dataloader"])
    val = cls(inst(cfg["validate_dataset"]["path"], cfg["validate_dataset"]["args"]),
              **cfg["validate_dataset"]["dataloader"])
    return train, [val]


@pytest.mark.parametrize("accum", [1, 2])
def test_trainer_matches_jax_over_one_epoch(accum, tmp_path):
    seed = 3407
    jcfg = _parity_config(tmp_path, accum)
    jcfg["meta"]["save_dir"] = str(tmp_path / "jax")
    margs = jcfg["model"]["args"]
    jmodel = jax_instantiate(jcfg["model"]["path"], {"seed": seed} | margs)
    jt = _JaxRecorder(config=jcfg, resume=False, model=jmodel,
                      optimizer_factory=jax_optimizer(jcfg["optimizer"]["path"],
                                                      jcfg["optimizer"]["args"])[0],
                      base_lr=1e-3)
    jt.rec = {}
    init_params = jax.tree.map(np.asarray, jmodel["params"])
    init_state = jax.tree.map(np.asarray, jmodel["state"])
    jt.train(*_loaders(JaxLoader, jcfg))
    jscores = jt.rec.setdefault("scores", [jt.state.best_score])

    pcfg = _parity_config(tmp_path, accum)
    pcfg["meta"]["save_dir"] = str(tmp_path / "port")
    pmodel = instantiate(pcfg["model"]["path"], {"seed": seed, "device": "cpu"} | margs)
    pmodel["params"] = params_from_numpy(init_params, "cpu")
    pmodel["state"] = params_from_numpy(init_state, "cpu")
    factory, lr = build_optimizer_factory(pcfg["optimizer"]["path"], pcfg["optimizer"]["args"])
    pt = _PortRecorder(config=pcfg, resume=False, model=pmodel, optimizer_factory=factory,
                       base_lr=lr, device="cpu")
    pt.rec = {}
    pt.train(*_loaders(DataLoader, pcfg))
    pt.close()

    updates = 4 // accum
    assert pt.state.steps_trained == jt.state.steps_trained == 4
    assert len(pt.rec["norms"]) == len(jt.rec["norms"]) == len(pt.rec["lrs"]) == updates
    assert pt.rec["lrs"] == [float(jt.lr_schedule(n)) for n in range(updates)]
    assert pt.rec["lrs"][0] == 0.0 and pt.rec["lrs"][1] > 0.0
    first, jfirst = pt.rec["losses"][0], jt.rec["losses"][0]
    assert sorted(first) == sorted(jfirst)
    for k in first:
        np.testing.assert_allclose(first[k], jfirst[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(pt.rec["norms"][0], jt.rec["norms"][0], rtol=1e-5)
    for got, want in zip(pt.rec["losses"][1:], jt.rec["losses"][1:]):
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(pt.rec["norms"], jt.rec["norms"], rtol=1e-3)
    np.testing.assert_allclose(pt.state.best_score, jscores[0], rtol=1e-3)


def test_max_steps_stops_at_exactly_that_many_updates(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = toml_load(SFS / "tiny_synthetic.toml")
    cfg["trainer"]["args"].update(max_steps=3, gradient_accumulation_steps=1)
    toml_dump(cfg, tmp_path / "tiny_synthetic.toml")
    t = _cli(SFS, "-M", "train")
    assert t.state.steps_trained == 3 and t.state.epochs_trained == 2
    assert sorted(p.name for p in (tmp_path / "exp" / "tiny_synthetic" / "checkpoints").iterdir()
                  ) == ["best", "epoch_0001", "epoch_0002"]


def test_cli_refusals(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    shutil.copy(SFS / "tiny_synthetic.toml", tmp_path / "tiny_synthetic.toml")
    if not torch.cuda.is_available():  # the default device is cuda, never the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["-C", "tiny_synthetic.toml", "-M", "train"], recipe_dir=SFS)

    # the fused flagship recipe validates on the CPU (the single scan written
    # out, at the recipe's full width) on synthetic data
    tiny = toml_load(SFS / "tiny_synthetic.toml")
    fused = toml_load(SFS / "baseline_m.toml")
    assert fused["model"]["args"]["scan_mode"] == "fused"
    for k in ("train_dataset", "validate_dataset", "test_dataset"):
        fused[k] = tiny[k]
    fused["validate_dataset"]["args"]["num_samples"] = 1
    toml_dump(fused, tmp_path / "baseline_m.toml")
    t = cli.main(["-C", "baseline_m.toml", "-M", "validate", "--device", "cpu"], recipe_dir=SFS)
    assert t.model_config.scan_mode == "fused" and t.model_config.fb_hidden_size == 320
    header = _mean_csv_header(tmp_path / "exp" / "baseline_m", 0)
    assert header[:2] == ["si_sdr", "stoi"] and "synops" in header

    # the GAN recipes take the GAN trainers
    freeze = RECIPES / "intel_ndns" / "spiking_fullsubnet_freeze_phase"
    from spiking_fullsubnet_torch.recipes.gan import DualGanDenoiseTrainer, GanDenoiseTrainer
    assert cli.trainer_class(SFS, toml_load(SFS / "tiny_synthetic_GAN.toml")) \
        is GanDenoiseTrainer
    assert cli.trainer_class(freeze, toml_load(freeze / "baseline_m_dualGAN.toml")) \
        is DualGanDenoiseTrainer

    # the separation recipes take the separation trainer; sdnn_delays its own
    # (its CLI runs are in test_torch_sdnn.py)
    from spiking_fullsubnet_torch.recipes.sdnn_delays import SdnnDelaysTrainer
    from spiking_fullsubnet_torch.recipes.separation import SeparationTrainer
    tasnet = RECIPES / "wsj0-mix" / "conv_tasnet"
    assert cli.trainer_class(tasnet, toml_load(tasnet / "tiny_synthetic.toml")) \
        is SeparationTrainer
    sdnn = RECIPES / "intel_ndns" / "sdnn_delays"
    for name in ("baseline.toml", "tiny_synthetic.toml"):
        assert cli.trainer_class(sdnn, toml_load(sdnn / name)) is SdnnDelaysTrainer
    with pytest.raises(NotImplementedError, match="remaining models and recipes"):
        cli.trainer_class(sdnn, {"trainer": {"path": "trainer_unknown.Trainer"}})
    # a [loss_function] path binds its args to the port's loss function
    tiny["loss_function"] = {"path": "torch.nn.L1Loss", "args": {}}
    tiny["trainer"]["args"]["max_epochs"] = 0
    toml_dump(tiny, tmp_path / "tiny_synthetic.toml")
    t = cli.main(["-C", "tiny_synthetic.toml", "--device", "cpu"], recipe_dir=SFS)
    x, y = torch.zeros(3), torch.tensor([1.0, -2.0, 3.0])
    assert t.loss_function(x, y).item() == 2.0 and t.state.epochs_trained == 0
    # the freeze phase's trainer is the GAN trainer (as in the JAX package),
    # which without a discriminator runs the plain denoise loop
    assert cli.trainer_class(freeze, toml_load(freeze / "baseline_m.toml")) is GanDenoiseTrainer
    assert issubclass(GanDenoiseTrainer, DenoiseTrainer)
