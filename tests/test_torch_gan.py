"""The port's MetricGAN trainers (``spiking_fullsubnet_torch/recipes/gan.py``)
against the JAX package's (``spiking_fullsubnet_tpu/recipes/gan.py``), on
the CPU.

- One generator step and one discriminator step of
  ``tiny_synthetic_GAN.toml`` in f64 from the same weights and batch,
  against the JAX trainer's ``_g_step`` and ``_d_step``: the generator's
  weights and BN state after the update, the discriminator's weights with
  ``u`` and ``v``, and every logged loss within 1e-9; the quality targets
  (``batch_mos``) equal.
- One epoch of ``tiny_synthetic_GAN.toml``, ``tiny_synthetic_dualGAN.toml``
  and the generator-only trainer against the JAX trainers from the same
  initial weights (the bounds of tests/test_torch_trainer.py): the first
  update's losses and gradient norm within rtol 1e-5, the later ones and
  the validation SI-SDR within 1e-3, every rate of the generator and of each
  discriminator equal.
- The GAN recipes through ``runtime.cli.main --device cpu``: train, ``-R``
  (the discriminators and their optimizer states restored from the
  checkpoint), test and predict; the generator-only recipe trains.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.data import DataLoader as JaxLoader
from spiking_fullsubnet_tpu.parallel.mesh import make_mesh
from spiking_fullsubnet_tpu.recipes import gan as JG
from spiking_fullsubnet_tpu.runtime.registry import (build_optimizer_factory as jax_optimizer,
                                                     instantiate as jax_instantiate)

from spiking_fullsubnet_torch.data import DataLoader
from spiking_fullsubnet_torch.models.discriminator import discriminator_weights, spectral_layers
from spiking_fullsubnet_torch.recipes import gan as PG
from spiking_fullsubnet_torch.runtime import cli
from spiking_fullsubnet_torch.runtime.checkpoint import CheckpointManager
from spiking_fullsubnet_torch.runtime.config import toml_dump, toml_load
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy
from spiking_fullsubnet_torch.runtime.registry import build_optimizer_factory, instantiate

RECIPES = Path(__file__).resolve().parent.parent / "recipes" / "intel_ndns"
SFS = RECIPES / "spiking_fullsubnet"
FREEZE = RECIPES / "spiking_fullsubnet_freeze_phase"
GAN_TOML = SFS / "tiny_synthetic_GAN.toml"
DUAL_TOML = FREEZE / "tiny_synthetic_dualGAN.toml"


def _np_tree(tree, dtype=None):
    return jax.tree.map(lambda a: np.asarray(a, dtype) if dtype else np.asarray(a), tree)


def _leaves_np(tree):
    return [x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in jax.tree.leaves(tree)]


def _model_section(cfg):
    return cfg.get("model") or cfg["model_g"]


def _optim_section(cfg):
    return cfg.get("optimizer") or cfg["optimizer_g"]


def _trainers(cfg, jcls, pcls, tmp_path, dtype=None):
    """A JAX trainer and a port trainer of ``cfg`` from the same initial
    weights (JAX's init, carried across; in ``dtype`` when given)."""
    seed = cfg["meta"]["seed"]
    cfg["meta"].setdefault("exp_id", "parity")
    margs = _model_section(cfg)["args"]
    jmodel = jax_instantiate(_model_section(cfg)["path"], {"seed": seed} | margs)
    jdiscs = JG.build_discriminator_bundles(cfg, seed)
    if dtype is not None:
        for bundle in [jmodel, *jdiscs.get("discriminators", {}).values()]:
            bundle["params"] = jax.tree.map(lambda a: jnp.asarray(a, dtype), bundle["params"])
        jmodel["state"] = jax.tree.map(lambda a: jnp.asarray(a, dtype), jmodel["state"])
    init = {"params": _np_tree(jmodel["params"]), "state": _np_tree(jmodel["state"]),
            "discs": {n: _np_tree(b["params"])
                      for n, b in jdiscs.get("discriminators", {}).items()}}
    ocfg = _optim_section(cfg)
    jcfg = dict(cfg, meta=dict(cfg["meta"], save_dir=str(tmp_path / "jax")))
    # on one device, as the port runs (the tests' eight virtual devices would
    # replicate every step eight times over)
    jopt, jlr = jax_optimizer(ocfg["path"], ocfg["args"])
    jt = jcls(config=jcfg, resume=False, model=jmodel, base_lr=jlr, optimizer_factory=jopt,
              mesh=make_mesh(devices=jax.devices()[:1]), **jdiscs)

    pmodel = instantiate(_model_section(cfg)["path"], {"seed": seed, "device": "cpu"} | margs)
    pmodel["params"] = params_from_numpy(init["params"], "cpu")
    pmodel["state"] = params_from_numpy(init["state"], "cpu")
    factory, lr = build_optimizer_factory(ocfg["path"], ocfg["args"])
    extra = {}
    if init["discs"]:
        extra["discriminators"] = {n: {"params": params_from_numpy(p, "cpu")}
                                   for n, p in init["discs"].items()}
    pcfg = dict(cfg, meta=dict(cfg["meta"], save_dir=str(tmp_path / "port")))
    pt = pcls(config=pcfg, resume=False, model=pmodel, optimizer_factory=factory, base_lr=lr,
              device="cpu", **extra)
    return jt, pt


def _batch(cfg, dtype):
    """The first training batch of ``cfg``'s synthetic dataset."""
    ds = cfg["train_dataset"]
    loader = DataLoader(instantiate(ds["path"], ds["args"]), shuffle=True,
                        seed=cfg["meta"]["seed"], **ds["dataloader"])
    noisy, clean = next(iter(loader))[:2]
    return noisy.astype(dtype), clean.astype(dtype)


def test_one_generator_and_discriminator_step_f64_match_jax(tmp_path):
    cfg = toml_load(GAN_TOML)
    jt, pt = _trainers(cfg, JG.GanDenoiseTrainer, PG.GanDenoiseTrainer, tmp_path,
                       dtype=jnp.float64)
    noisy, clean = _batch(cfg, np.float64)
    jt._steps_per_epoch = 2
    disc_before = [a.copy() for a in _leaves_np(pt.disc_params["d"])]
    jt._build_optimizer(max_steps=2)
    lr, dlr = float(jt.lr_schedule(0)), float(jt._disc_schedule("d", 2)(0))
    assert lr == dlr == float(np.float32(1e-3))

    (jparams, jstate, _, jaux, jnorm, jenh, jenh_mag, jclean_mag) = jt._g_step(
        jt.params, jt.model_state, jt.opt_state, jt.disc_params, jnp.asarray(noisy),
        jnp.asarray(clean))
    jmos = jt.batch_mos(np.asarray(jenh), clean, ["OVRL"])
    jdisc, _, jaux_d = jt._d_step(jt.disc_params["d"], jt.disc_opt_states["d"], jt.disc_txs["d"],
                                  jclean_mag, jenh_mag, jnp.asarray(jmos["OVRL"]))

    aux, norm, enh, enh_mag, clean_mag = pt.generator_step(
        torch.from_numpy(noisy), torch.from_numpy(clean), lr)
    mos = pt.batch_mos(enh.numpy(), clean, ["OVRL"])
    assert mos.keys() == jmos.keys() and mos["OVRL"].dtype == np.float32
    np.testing.assert_array_equal(mos["OVRL"], jmos["OVRL"])
    assert 0.0 <= mos["OVRL"].min() and mos["OVRL"].max() <= 1.0
    aux_d = pt.discriminator_step("d", clean_mag, enh_mag, torch.from_numpy(mos["OVRL"]), dlr)

    # the clip does not act at this norm, so torch's and optax's clips agree
    assert float(norm) < pt.max_grad_norm
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-9)
    assert sorted(aux) == sorted(jaux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(jaux[k]), rtol=1e-9, atol=1e-12,
                                   err_msg=k)
    for k in aux_d:
        np.testing.assert_allclose(float(aux_d[k]), float(jaux_d[k]), rtol=1e-9, err_msg=k)
    for name, got, want in [("enh_mag", enh_mag, jenh_mag), ("clean_mag", clean_mag, jclean_mag)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-9, err_msg=name)
    for got, want in [(pt.params, jparams), (pt.model_state, jstate),
                      (pt.disc_params["d"], jdisc)]:
        got, want = _leaves_np(got), _leaves_np(want)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-9, rtol=0)
    # every tensor of the discriminator moved, u and v included
    moved = [float(np.abs(a - b).max()) for a, b in
             zip(_leaves_np(pt.disc_params["d"]), disc_before)]
    assert min(moved) > 0


class _Recorder:
    """Records every update's gradient norm and rate, each discriminator's
    rate, and every step's loss dict."""

    def record(self, key, value):
        self.rec.setdefault(key, []).append(value)

    def training_epoch_end(self, out):
        self.rec.setdefault("losses", []).extend(out)
        super().training_epoch_end(out)


def _port_recorder(cls):
    class Port(_Recorder, cls):
        def _log_step(self, grad_norm, lr):
            self.record("norms", float(grad_norm))
            self.record("lrs", lr)
            super()._log_step(grad_norm, lr)

        def discriminator_step(self, name, clean_mag, enh_mag, target, lr):
            self.record(f"lr_{name}", lr)
            return super().discriminator_step(name, clean_mag, enh_mag, target, lr)
    return Port


def _jax_recorder(cls):
    class Jax(_Recorder, cls):
        def _log_step(self, loss_dict, grad_norm):
            self.record("norms", float(grad_norm))
            super()._log_step(loss_dict, grad_norm)
    return Jax


def _loaders(loader_cls, cfg):
    inst = jax_instantiate if loader_cls is JaxLoader else instantiate
    train = loader_cls(inst(cfg["train_dataset"]["path"], cfg["train_dataset"]["args"]),
                       shuffle=True, seed=cfg["meta"]["seed"], **cfg["train_dataset"]["dataloader"])
    val = loader_cls(inst(cfg["validate_dataset"]["path"], cfg["validate_dataset"]["args"]),
                     **cfg["validate_dataset"]["dataloader"])
    return train, [val]


def _only_gen(cfg):
    cfg["trainer"]["path"] = "trainer_onlyGen.Trainer"
    for key in ("model_d_sig", "model_d_bak"):
        cfg.pop(key)
    return cfg


def _max_steps_mid_epoch(cfg):
    """``max_steps`` 3 of an epoch's four updates, and accumulation asked
    for: the GAN loop runs the whole epoch, one update a batch."""
    cfg["trainer"]["args"].update(max_steps=3, gradient_accumulation_steps=2)
    return cfg


RECIPES_ONE_EPOCH = {
    "gan": (GAN_TOML, JG.GanDenoiseTrainer, PG.GanDenoiseTrainer, lambda c: c, ["d"]),
    "gan_max_steps": (GAN_TOML, JG.GanDenoiseTrainer, PG.GanDenoiseTrainer,
                      _max_steps_mid_epoch, ["d"]),
    "dual_gan": (DUAL_TOML, JG.DualGanDenoiseTrainer, PG.DualGanDenoiseTrainer, lambda c: c,
                 ["d_sig", "d_bak"]),
    "only_gen": (DUAL_TOML, JG.OnlyGenTrainer, PG.OnlyGenTrainer, _only_gen, []),
}


@pytest.mark.parametrize("recipe", list(RECIPES_ONE_EPOCH))
def test_one_epoch_matches_jax(recipe, tmp_path):
    toml, jcls, pcls, edit, discs = RECIPES_ONE_EPOCH[recipe]
    cfg = edit(toml_load(toml))
    cfg["meta"]["exp_id"] = recipe
    cfg["train_dataset"]["args"]["num_samples"] = 8  # four updates
    jt, pt = _trainers(cfg, _jax_recorder(jcls), _port_recorder(pcls), tmp_path)
    jt.rec, pt.rec = {}, {}
    jt.train(*_loaders(JaxLoader, cfg))
    pt.train(*_loaders(DataLoader, cfg))
    pt.close()

    max_steps = cfg["trainer"]["args"].get("max_steps", 0) or 4
    assert pt.state.steps_trained == jt.state.steps_trained == 4
    assert pt.state.epochs_trained == jt.state.epochs_trained == 1
    assert len(pt.rec["norms"]) == len(jt.rec["norms"]) == 4
    assert pt.rec["lrs"] == [float(jt.lr_schedule(n)) for n in range(4)]
    for name in discs:
        assert pt.rec[f"lr_{name}"] == [float(jt._disc_schedule(name, max_steps)(n))
                                        for n in range(4)]
    first, jfirst = pt.rec["losses"][0], jt.rec["losses"][0]
    assert sorted(first) == sorted(jfirst)
    for k in first:
        np.testing.assert_allclose(first[k], jfirst[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(pt.rec["norms"][0], jt.rec["norms"][0], rtol=1e-5)
    for got, want in zip(pt.rec["losses"][1:], jt.rec["losses"][1:]):
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)
    np.testing.assert_allclose(pt.rec["norms"], jt.rec["norms"], rtol=1e-3)
    np.testing.assert_allclose(pt.state.best_score, jt.state.best_score, rtol=1e-3)
    if recipe == "only_gen":
        assert list(first) == ["loss_g", "loss_freq_mae", "loss_mag_mae"]
        assert cli.trainer_class(FREEZE, cfg) is PG.OnlyGenTrainer


@pytest.mark.parametrize("toml,recipe_dir,names", [(GAN_TOML, SFS, ["d"]),
                                                    (DUAL_TOML, FREEZE, ["d_sig", "d_bak"])],
                         ids=["gan", "dual_gan"])
def test_cli_train_resume_test_predict(toml, recipe_dir, names, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = toml_load(toml)
    toml_dump(cfg, tmp_path / toml.name)

    def run(*argv):
        return cli.main(["-C", toml.name, *argv, "--device", "cpu"], recipe_dir=recipe_dir)

    t = run("-M", "train")
    assert isinstance(t, PG.GanDenoiseTrainer) and list(t.disc_params) == names
    assert t.state.epochs_trained == 1 and t.state.steps_trained == 2
    exp = tmp_path / "exp" / toml.stem
    saved = CheckpointManager(exp / "checkpoints").load("latest")
    assert sorted(saved["disc_params"]) == sorted(names)
    for name in names:
        for a, b in zip(_leaves_np(saved["disc_params"][name]), _leaves_np(t.disc_params[name])):
            np.testing.assert_array_equal(a, b)
        state = saved["disc_opt_states"][name]["state"]
        assert len(state) == len(discriminator_weights(t.disc_params[name]))
        assert all(int(s["step"]) == 2 for s in state.values())

    # -R with one more epoch: the discriminators and their moments come back
    cfg["trainer"]["args"]["max_epochs"] = 2
    toml_dump(cfg, tmp_path / toml.name)
    seen = {}
    real = PG.GanDenoiseTrainer.discriminator_step

    def first_disc_step(self, name, *a):
        if name not in seen:
            params = self.disc_params[name]
            seen[name] = ([w.detach().clone() for w in discriminator_weights(params)],
                          [layer["u"].clone() for layer in spectral_layers(params)],
                          {k: int(s["step"]) for k, s in
                           self.disc_optimizers[name].state_dict()["state"].items()})
        return real(self, name, *a)

    monkeypatch.setattr(PG.GanDenoiseTrainer, "discriminator_step", first_disc_step)
    t2 = run("-M", "train", "-R")
    assert t2.state.epochs_trained == 2 and t2.state.steps_trained == 4
    for name in names:
        weights, us, steps = seen[name]
        for a, b in zip(weights, discriminator_weights(saved["disc_params"][name])):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for a, layer in zip(us, spectral_layers(saved["disc_params"][name])):
            torch.testing.assert_close(a, layer["u"], rtol=0, atol=0)
        assert set(steps.values()) == {2}
    assert (exp / "checkpoints" / "epoch_0002").is_dir()

    t3 = run("-M", "test", "predict", "--ckpt_path", "best")
    assert t3.state.epochs_trained == t2.state.best_score_epoch
    assert sorted((exp / "enhanced" / "dataloader_0").glob("*.wav"))


def test_cli_trains_the_generator_only_recipe(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _only_gen(toml_load(DUAL_TOML))
    toml_dump(cfg, tmp_path / "tiny_onlyGen.toml")
    t = cli.main(["-C", "tiny_onlyGen.toml", "-M", "train", "--device", "cpu"],
                 recipe_dir=FREEZE)
    assert type(t) is PG.OnlyGenTrainer and t.state.epochs_trained == 1
    assert (tmp_path / "exp" / "tiny_onlyGen" / "checkpoints" / "epoch_0001").is_dir()
