"""The port's wsj0-mix separation recipes against the JAX package.

- ``SyntheticMixDataset`` equal to the JAX one item for item;
  ``WSJ0MixDataset`` on wavs written to a temporary directory, from
  directories and from scp lists, its aligned training crops equal to the
  JAX ones under the same numpy seed; the loader stacks the ``[2, T]``
  references into ``[B, 2, T]`` and collates the stems into a list, as the
  JAX loader does;
- one PIT training step of the tiny two-speaker Spiking-FullSubNet
  (``recipes/wsj0-mix/spiking_fullsubnet/tiny_synthetic.toml``'s model) in
  float64 from JAX's weights: the loss ``pit_wrapper(pairwise_neg_sisdr,
  ...)`` over the forward (``recipes/separation.py:39-43``) and every
  gradient leaf against ``jax.grad``, within 1e-9 (the gradients relative to
  their largest value), the new BN state within 1e-9;
- the two-speaker model's eval route (the layered forward, kernel F's
  plain version on the CPU) against the fused forward's single scan
  (``fused_forward_plain``, the card's oracle in ``chip_smoke.py``) in
  float64: spikes equal, audio within 1e-9; the kernels' host-side plans
  (D's and E's ``train_plan``, F's ``stack_x_plan``) take every GSU stack
  of the two-speaker and REVERB recipes at their training and validation
  batches;
- cIRM-LSTM (``pad_to_hop``, two speakers, no BN) in float64: the tiny
  recipe's widths and the default recipe's on 0.5 s, the separated audio
  within atol 3e-6 (tests/test_stream_forward.py:53), at a length that is a
  hop multiple (padded by a whole hop, as JAX pads) and at one that is not;
- the three ``wsj0-mix/*/tiny_synthetic.toml`` recipes through the port's
  CLI on the CPU: train, ``-R``, test on ``best``, predict;
- one epoch of the tiny two-speaker recipe against the JAX ``Trainer`` from
  the same initial weights, within the bounds of
  tests/test_torch_trainer.py:141: the first update's loss within rtol 1e-5
  in float32, the second's, both gradient norms and the validation SI-SDR
  within rtol 1e-3. The first gradient norm of each package is held within
  rtol 1e-5 of the same update in float64 (the port's, which the step test
  above holds to JAX's at 1e-9): in float32 the two packages round apart by
  1.2e-5 there (84.26926 and 84.26820 against 84.26846), each within 1e-5
  of the float64 value.
Inputs are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

import shutil
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.data import DataLoader as JaxLoader
from spiking_fullsubnet_tpu.data import wsj0_mix as JW
from spiking_fullsubnet_tpu.losses import pairwise_neg_sisdr as j_pairwise
from spiking_fullsubnet_tpu.losses import pit_wrapper as j_pit
from spiking_fullsubnet_tpu.models import cirm_models as JC
from spiking_fullsubnet_tpu.models import spiking_fullsubnet as J
from spiking_fullsubnet_tpu.parallel.mesh import make_mesh
from spiking_fullsubnet_tpu.recipes import SeparationTrainer as JaxSeparationTrainer
from spiking_fullsubnet_tpu.runtime.registry import (build_optimizer_factory as jax_optimizer,
                                                     instantiate as jax_instantiate)

from spiking_fullsubnet_torch.data import DataLoader
from spiking_fullsubnet_torch.data import wsj0_mix as PW
from spiking_fullsubnet_torch.dsp.io import save_wav
from spiking_fullsubnet_torch.models import cirm_models as PC
from spiking_fullsubnet_torch.models import spiking_fullsubnet as P
from spiking_fullsubnet_torch.models.fused_forward import fused_forward_plain
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.recipes.separation import SeparationTrainer, separation_loss
from spiking_fullsubnet_torch.runtime import cli
from spiking_fullsubnet_torch.runtime.config import toml_load
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy
from spiking_fullsubnet_torch.runtime.registry import build_optimizer_factory, instantiate

WSJ0 = Path(__file__).resolve().parent.parent / "recipes" / "wsj0-mix"
SFS, TASNET, CIRM = WSJ0 / "spiking_fullsubnet", WSJ0 / "conv_tasnet", WSJ0 / "cirm_lstm"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


# ------------------------------------------------------------------ data


def test_synthetic_mix_dataset_equals_jax():
    kw = dict(num_samples=3, duration=0.3, sr=8000, seed=5)
    port, ref = PW.SyntheticMixDataset(**kw), JW.SyntheticMixDataset(**kw)
    assert len(port) == len(ref) == 3
    for i in range(3):
        got, want = port[i], ref[i]
        assert got[2] == want[2] == f"mix_{i}"
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
        assert got[1].shape == (2, 2400)


def _write_mixtures(root: Path, n: int, lengths):
    rng = np.random.default_rng(3)
    dirs = {k: root / k for k in ("mix", "s1", "s2")}
    for d in dirs.values():
        d.mkdir(parents=True)
    for i in range(n):
        s1, s2 = (0.2 * rng.standard_normal(lengths[i]) for _ in range(2))
        save_wav(s1, dirs["s1"] / f"utt{i}.wav", 8000)
        save_wav(s2, dirs["s2"] / f"utt{i}.wav", 8000)
        save_wav(s1 + s2, dirs["mix"] / f"utt{i}.wav", 8000)
    return dirs


@pytest.mark.parametrize("source", ["dirs", "scp"])
def test_wsj0_mix_dataset_and_loader_equal_jax(source, tmp_path):
    dirs = _write_mixtures(tmp_path / "wav", 5, [3000, 2500, 4100, 1200, 3333])
    if source == "scp":
        lists = {}
        for k, d in dirs.items():
            lists[k] = tmp_path / f"{k}.scp"
            lists[k].write_text("\n".join(str(p) for p in sorted(d.glob("*.wav"))) + "\n")
        args = [lists["mix"], lists["s1"], lists["s2"]]
    else:
        args = [dirs["mix"], dirs["s1"], dirs["s2"]]
    for kw in (dict(is_train=True, duration=0.25, offset=1, limit=3), dict(is_train=False)):
        port, ref = PW.WSJ0MixDataset(*args, **kw), JW.WSJ0MixDataset(*args, **kw)
        assert len(port) == len(ref) == (3 if kw["is_train"] else 5)
        for i in range(len(ref)):
            np.random.seed(11 + i)
            want = ref[i]
            np.random.seed(11 + i)
            got = port[i]
            assert got[2] == want[2]
            for g, w in zip(got[:2], want[:2]):
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g, w)
            if kw["is_train"]:
                assert got[1].shape == (2, 2000)
                # one crop for the mixture and both sources: mix = s1 + s2
                # up to the wavs' 16-bit rounding
                assert np.abs(got[0] - got[1].sum(0)).max() < 1e-3
    train = dict(is_train=True, duration=0.25)
    np.random.seed(2)
    batches = list(DataLoader(PW.WSJ0MixDataset(*args, **train), batch_size=2, shuffle=True,
                              seed=4, drop_last=True))
    np.random.seed(2)
    jbatches = list(JaxLoader(JW.WSJ0MixDataset(*args, **train), batch_size=2, shuffle=True,
                              seed=4, drop_last=True))
    assert len(batches) == len(jbatches) == 2
    for b, jb in zip(batches, jbatches):
        assert b[0].shape == (2, 2000) and b[1].shape == (2, 2, 2000)
        assert isinstance(b[2], list) and b[2] == list(jb[2])
        np.testing.assert_array_equal(b[0], np.asarray(jb[0]))
        np.testing.assert_array_equal(b[1], np.asarray(jb[1]))


# ------------------------------------------------------------------ models


def _mixtures(batch, n, seed):
    ds = PW.SyntheticMixDataset(num_samples=batch, duration=n / 8000, seed=seed)
    mix, ref, _ = zip(*(ds[i] for i in range(batch)))
    rng = np.random.default_rng(seed)
    return (np.stack(mix).astype(np.float64) + 0.01 * rng.standard_normal((batch, n)),
            np.stack(ref).astype(np.float64))


def test_pit_train_step_of_the_two_speaker_model_matches_jax_f64():
    margs = toml_load(SFS / "tiny_synthetic.toml")["model"]["args"]
    jb = jax_instantiate("spiking_fullsubnet_tpu.models.spiking_fullsubnet.build",
                         {"seed": 2} | margs)
    jcfg = jb["config"]
    assert jcfg.num_spks == 2 and jcfg.n_fft == 256 and jcfg.scan_mode == "layered"
    p, s = _f64(jb["params"]), _f64(jb["state"])
    mix, ref = _mixtures(4, 2000, 1)

    def loss_fn(pp):
        out = J.spiking_fullsubnet_apply(jcfg, pp, s, jnp.asarray(mix), train=True)
        return j_pit(j_pairwise, out["enhanced_y"], jnp.asarray(ref))[0], out["state"]

    (ref_loss, ref_state), ref_g = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, p))

    pb = P.build(seed=2, device="cpu", **margs)
    assert pb["config"].__dict__ == jcfg.__dict__
    tp = params_from_numpy(p, "cpu")
    leaves = jax.tree.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    out = P.spiking_fullsubnet_apply(pb["config"], tp, params_from_numpy(s, "cpu"),
                                     torch.from_numpy(mix), train=True)
    assert out["enhanced_y"].shape == (4, 2, 2000)
    loss = separation_loss(out["enhanced_y"], torch.from_numpy(ref))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-9)
    g_leaves = jax.tree_util.tree_leaves_with_path(ref_g)
    assert len(g_leaves) == len(leaves) > 0
    for (path, r), t in zip(g_leaves, leaves):
        r = np.asarray(r)
        np.testing.assert_allclose(t.grad.numpy(), r, atol=1e-9 * (1e-30 + np.abs(r).max()),
                                   rtol=0, err_msg=jax.tree_util.keystr(path))
    for a, r in zip(jax.tree.leaves(out["state"]), jax.tree.leaves(ref_state)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), atol=1e-9, rtol=0)


def test_two_speaker_eval_route_equals_the_fused_scan_f64():
    margs = toml_load(SFS / "tiny_synthetic.toml")["model"]["args"]
    pb = P.build(seed=5, device="cpu", **margs)
    cfg = pb["config"]
    p = _f64(jax.tree.map(lambda t: t.numpy(), pb["params"]))
    s = _f64(jax.tree.map(lambda t: t.numpy(), pb["state"]))
    rng = np.random.default_rng(6)
    for ls in s["fb"]["stack"]["layers"]:
        ls["bn"]["running_mean"] = 0.1 * rng.standard_normal(ls["bn"]["running_mean"].shape)
    tp, ts = params_from_numpy(p, "cpu"), params_from_numpy(s, "cpu")
    mix, _ = _mixtures(2, 2400, 4)
    with torch.no_grad():
        out = P.spiking_fullsubnet_apply(cfg, tp, ts, torch.from_numpy(mix))
        plain = fused_forward_plain(replace(cfg, scan_mode="fused"), tp, ts, torch.from_numpy(mix))
    assert out["enhanced_y"].shape == (2, 2, 2400)
    np.testing.assert_allclose(out["enhanced_y"].numpy(), plain["enhanced_y"].numpy(), atol=1e-9,
                               rtol=0)
    for key in ("fb_all_layer_outputs", "sb_all_layer_outputs"):
        for a, b in zip(jax.tree.leaves(out[key]), jax.tree.leaves(plain[key])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-9, rtol=0)


@pytest.mark.parametrize("toml", [SFS / "default.toml",
                                  WSJ0.parent / "reverb" / "spiking_fullsubnet" / "default.toml"],
                         ids=["wsj0_mix", "reverb"])
def test_kernel_plans_take_the_recipe_shapes(toml):
    recipe = toml_load(toml)
    cfg = P.SpikingFullSubNetConfig(**P._norm_cfg_args(recipe["model"]["args"]))
    # (rows per utterance, features, units) of every GSU stack: the fullband,
    # then each section with its units folded into the rows
    stacks = [(1, cfg.fb_input_size, cfg.fb_hidden_size)]
    for i in range(cfg.num_sections):
        units = (cfg.freq_cutoffs[i + 1] - cfg.freq_cutoffs[i]) // cfg.center_freq_sizes[i]
        stacks.append((units, cfg.sb_config(i).input_size, cfg.sb_hidden_size))
    if cfg.n_fft == 256:
        assert stacks == [(1, 32, 320), (8, 18, 224), (3, 46, 224), (2, 78, 224)]
    batches = [recipe[k]["dataloader"]["batch_size"] for k in ("train_dataset", "validate_dataset")]
    for rows, feats, hidden in stacks:
        for batch in batches:
            for kernel in ("fwd", "bwd"):
                assert gk.train_plan(batch * rows, hidden, True, torch.float32, kernel)["fits"]
            plan = gk.stack_x_plan(batch * rows, feats, hidden, 2, True, torch.float32)
            assert plan["blocks"] >= 1


@pytest.mark.parametrize("n_samples", [4000, 4030], ids=["hop_multiple", "not_hop_multiple"])
@pytest.mark.parametrize("toml", ["tiny_synthetic.toml", "default.toml"], ids=["tiny", "recipe"])
def test_cirm_lstm_matches_jax_f64(toml, n_samples):
    margs = toml_load(CIRM / toml)["model"]["args"]
    jb = JC.build(seed=0, **margs)
    jcfg = jb["config"]
    assert jcfg.sequence_model == "LSTM" and jcfg.pad_to_hop and jcfg.num_spks == 2
    p = _f64(jb["params"])
    p["fb"]["pre_ln"]["weight"] = 1 + 0.2 * np.random.default_rng(1).standard_normal(
        p["fb"]["pre_ln"]["weight"].shape)
    mix, _ = _mixtures(2, n_samples, 3)
    ref = JC.cirm_model_apply(jcfg, p, {"fb": {"stack": {}}}, jnp.asarray(mix))
    pb = PC.build(seed=0, device="cpu", **margs)
    assert pb["config"].__dict__ == jcfg.__dict__
    out = PC.cirm_model_apply(pb["config"], params_from_numpy(p, "cpu"), pb["state"],
                              torch.from_numpy(mix))
    assert out["enhanced_y"].shape == ref["enhanced_y"].shape == (2, 2, n_samples)
    assert out["all_layer_outputs"] == [] and out["state"] == {"fb": {"stack": {}}}
    np.testing.assert_allclose(out["enhanced_y"].numpy(), np.asarray(ref["enhanced_y"]),
                               atol=3e-6, rtol=0)
    assert np.abs(np.asarray(ref["enhanced_y"])).max() > 1e-3


# ------------------------------------------------------------------ the recipes


def _mean_csv_header(exp, epoch):
    csvs = sorted((exp / "metrics").glob(f"dl_0_epoch_{epoch}_*_mean.csv"))
    assert csvs
    return csvs[-1].read_text().splitlines()[0].split(",")


@pytest.mark.parametrize("recipe_dir", [SFS, TASNET, CIRM], ids=lambda d: d.name)
def test_cli_train_resume_test_predict(recipe_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    shutil.copy(recipe_dir / "tiny_synthetic.toml", tmp_path / "tiny_synthetic.toml")

    def run(*argv):
        return cli.main(["-C", "tiny_synthetic.toml", *argv, "--device", "cpu"],
                        recipe_dir=recipe_dir)

    t = run("-M", "train")
    assert type(t) is SeparationTrainer and t.state.epochs_trained == 1
    assert t.state.steps_trained == 2
    exp = tmp_path / "exp" / "tiny_synthetic"
    ckpts = sorted(p.name for p in (exp / "checkpoints").iterdir())
    assert ckpts == ["best", "epoch_0001"]
    assert _mean_csv_header(exp, 1) == ["si_sdr"]
    assert np.isfinite(t.state.best_score) and t.state.best_score > -100

    t2 = run("-M", "train", "-R")  # max_epochs reached already: counters back, no epoch run
    assert t2.state.epochs_trained == 1 and t2.state.steps_trained == 2
    t3 = run("-M", "test", "--ckpt_path", "best")
    assert t3.state.epochs_trained == t.state.best_score_epoch == 1
    # the JAX separation trainer writes nothing in predict (no predict_step)
    run("-M", "predict", "--ckpt_path", "best")
    assert not list((exp / "enhanced").rglob("*.wav"))


class _PortRecorder(SeparationTrainer):
    def _log_step(self, grad_norm, lr):
        self.rec.setdefault("norms", []).append(float(grad_norm))
        super()._log_step(grad_norm, lr)

    def training_epoch_end(self, out):
        self.rec.setdefault("losses", []).extend(out)
        super().training_epoch_end(out)


class _JaxRecorder(JaxSeparationTrainer):
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


def test_one_epoch_matches_the_jax_trainer(tmp_path):
    def config(sub):
        cfg = toml_load(SFS / "tiny_synthetic.toml")
        cfg["meta"].update(exp_id="parity", save_dir=str(tmp_path / sub))
        return cfg

    jcfg = config("jax")
    margs, seed = jcfg["model"]["args"], jcfg["meta"]["seed"]
    jmodel = jax_instantiate(jcfg["model"]["path"], {"seed": seed} | margs)
    init = jax.tree.map(np.asarray, (jmodel["params"], jmodel["state"]))
    jt = _JaxRecorder(config=jcfg, resume=False, model=jmodel,
                      optimizer_factory=jax_optimizer(jcfg["optimizer"]["path"],
                                                      jcfg["optimizer"]["args"])[0],
                      base_lr=1e-3, mesh=make_mesh(devices=jax.devices()[:1]))
    jt.rec = {}
    jt.train(*_loaders(JaxLoader, jcfg))

    pcfg = config("port")
    pmodel = instantiate(pcfg["model"]["path"], {"seed": seed, "device": "cpu"} | margs)
    pmodel["params"] = params_from_numpy(init[0], "cpu")
    pmodel["state"] = params_from_numpy(init[1], "cpu")
    factory, lr = build_optimizer_factory(pcfg["optimizer"]["path"], pcfg["optimizer"]["args"])
    pt = _PortRecorder(config=pcfg, resume=False, model=pmodel, optimizer_factory=factory,
                       base_lr=lr, device="cpu")
    pt.rec = {}
    pt.train(*_loaders(DataLoader, pcfg))
    pt.close()

    assert pt.state.steps_trained == jt.state.steps_trained == 2
    assert len(pt.rec["norms"]) == len(jt.rec["norms"]) == 2
    first, jfirst = pt.rec["losses"], jt.rec["losses"]
    assert [sorted(r) for r in first] == [sorted(r) for r in jfirst] == [["loss"]] * 2
    np.testing.assert_allclose(first[0]["loss"], jfirst[0]["loss"], rtol=1e-5)
    # the first update in float64: the loader's first batch, the initial weights
    mix, ref, _ = next(iter(_loaders(DataLoader, pcfg)[0]))
    tp = params_from_numpy(_f64(init[0]), "cpu")
    leaves = jax.tree.leaves(tp)
    for t in leaves:
        t.requires_grad_(True)
    out = pmodel["apply"](pmodel["config"], tp, params_from_numpy(_f64(init[1]), "cpu"),
                          torch.from_numpy(mix.astype(np.float64)), train=True)
    separation_loss(out["enhanced_y"], torch.from_numpy(ref.astype(np.float64))).backward()
    norm64 = torch.sqrt(sum((t.grad ** 2).sum() for t in leaves)).item()
    np.testing.assert_allclose([pt.rec["norms"][0], jt.rec["norms"][0]], [norm64] * 2, rtol=1e-5)
    np.testing.assert_allclose(first[1]["loss"], jfirst[1]["loss"], rtol=1e-3)
    np.testing.assert_allclose(pt.rec["norms"], jt.rec["norms"], rtol=1e-3)
    np.testing.assert_allclose(pt.state.best_score, jt.state.best_score, rtol=1e-3)
