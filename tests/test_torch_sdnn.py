"""The port's SDNN with delays (models/sdnn.py) and its recipe
(recipes/sdnn_delays.py) against the JAX package, in float64.

- ``ste_round``: round half to even on x.5, as ``jnp.round``; the
  gradient the identity;
- ``quantize`` on the delta stage's rounding ties as the JAX package's
  compiled scan rounds them; the delta stage and the sigma stage: the
  deltas equal JAX's exactly (the reconstruction rounded once, as XLA's
  fused multiply-add), the sums within 1e-12, and they reconstruct the
  input to within half a threshold;
- ``_apply_delay`` with delays inside, on both bounds (0 and
  ``max_delay``) and outside them: values and the gradients of a weighted
  sum against ``jax.grad`` within 1e-12, where the clip's gradient is 1/2
  on a bound (as ``jnp.clip``'s);
- ``sdnn_apply`` at ``baseline.toml``'s widths (257 -> 512 -> 512 -> 257,
  ``max_delay`` 64), 64 frames: within 1e-9 of JAX (a delta that rounds
  the other way would move the output by a whole threshold step);
- one recipe update in float64: the loss and every gradient against
  ``jax.value_and_grad`` of the JAX recipe's ``training_step_fn`` (rtol
  1e-9; gradients within 1e-9 of each leaf's largest);
- ``tiny_synthetic.toml`` through the CLI with ``--device cpu``: train,
  ``-R``, test and predict; without it the CLI wants CUDA.
"""

from __future__ import annotations

import importlib.util
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.models import sdnn as JS

from spiking_fullsubnet_torch.models import sdnn as PS
from spiking_fullsubnet_torch.recipes.sdnn_delays import SdnnDelaysTrainer, sdnn_loss
from spiking_fullsubnet_torch.runtime import cli
from spiking_fullsubnet_torch.runtime.config import toml_load
from spiking_fullsubnet_torch.runtime.convert import flat_paths, params_from_numpy

ROOT = Path(__file__).resolve().parent.parent
RECIPE = ROOT / "recipes" / "intel_ndns" / "sdnn_delays"


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


def test_ste_round_halves_to_even_and_passes_the_gradient():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5, 0.49, 2.51], dtype=torch.float64,
                     requires_grad=True)
    y = PS.ste_round(x)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(JS.ste_round(x.detach().numpy())))
    assert y.detach().tolist() == [0.0, 2.0, 2.0, -0.0, -2.0, 0.0, 3.0]
    (y * torch.arange(7.0, dtype=torch.float64)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.arange(7.0))
    q = PS.quantize(torch.tensor([0.0312, 0.05, -0.2]), 1.0 / 64)
    np.testing.assert_array_equal(q.numpy(), np.asarray(JS.quantize(jnp.asarray(
        [0.0312, 0.05, -0.2], jnp.float32), 1.0 / 64)))
    # ties of the delta stage: 0.25 - 0.2 and 0.35 at a threshold of 0.1, as
    # the JAX package computes them compiled (its scan body)
    ties = np.array([0.25 - 0.2, 0.35, 0.15000000000000002, -0.35])
    np.testing.assert_array_equal(
        PS.quantize(torch.from_numpy(ties), 0.1).numpy(),
        np.asarray(jax.jit(lambda v: JS.quantize(v, 0.1))(jnp.asarray(ties))))


def test_delta_and_sigma_round_trip_equal_jax():
    x = np.cumsum(np.random.default_rng(0).standard_normal((40, 3, 5)) * 0.3, axis=0)
    d = PS._delta_encode(torch.from_numpy(x), 0.1)
    np.testing.assert_array_equal(d.numpy(), np.asarray(JS._delta_encode(jnp.asarray(x), 0.1)))
    recon = PS._sigma_decode(d).numpy()
    # the prefix sums in another order: within 1e-12
    np.testing.assert_allclose(recon, np.asarray(JS._sigma_decode(jnp.asarray(d.numpy()))),
                               atol=1e-12, rtol=0)
    assert np.abs(recon - x).max() <= 0.05 + 1e-12
    # every delta is a whole number of thresholds
    np.testing.assert_allclose(d.numpy() / 0.1, np.round(d.numpy() / 0.1), atol=1e-9)


def test_delay_and_its_gradient_match_jax():
    t, b, f, max_delay = 20, 2, 8, 6
    rng = np.random.default_rng(1)
    x = rng.standard_normal((t, b, f))
    delay = np.array([0.0, 6.0, -1.5, 7.25, 0.3, 2.0, 5.999, 3.5])  # bounds, outside, inside
    w = rng.standard_normal((t, b, f))

    def jloss(xx, dd):
        return jnp.sum(JS._apply_delay(xx, dd, max_delay) * w)

    ref = JS._apply_delay(jnp.asarray(x), jnp.asarray(delay), max_delay)
    gx, gd = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(delay))
    tx = torch.from_numpy(x).requires_grad_(True)
    td = torch.from_numpy(delay).requires_grad_(True)
    out = PS._apply_delay(tx, td, max_delay)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-12, rtol=0)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-12, rtol=0)
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(gd), atol=1e-12, rtol=0)
    # the clip's gradient is a half on a bound: delays 0 and max_delay move
    assert td.grad[0] != 0 and td.grad[1] != 0 and td.grad[2] == 0 and td.grad[3] == 0
    for shift in (0, 3, 25):
        np.testing.assert_array_equal(PS.delay_signal(torch.from_numpy(x), shift, 0).numpy(),
                                      np.asarray(JS.delay_signal(jnp.asarray(x), shift, 0)))


def _baseline_args():
    return dict(toml_load(RECIPE / "baseline.toml")["model"]["args"])


def test_sdnn_apply_at_baseline_widths_matches_jax_f64():
    args = _baseline_args()
    assert (args["input_size"], args["hidden_size"], args["max_delay"]) == (257, 512, 64)
    jb = JS.build(seed=0, **args)
    params = _f64(jb["params"])
    # delays spread over [0, max_delay] so that the gather reaches back
    params["delay1"] = np.linspace(0.0, 64.0, 512)
    params["delay2"] = np.linspace(64.0, 0.0, 512)
    mag = np.abs(np.random.default_rng(2).standard_normal((2, 257, 64))) * 0.5
    ref = jax.jit(lambda p, m: JS.sdnn_apply(jb["config"], p, m))(params, jnp.asarray(mag))
    b = PS.build(seed=0, device="cpu", **args)
    assert b["config"] == PS.SDNNConfig(**args) and b["state"] == {}
    assert {k: tuple(v.shape) for k, v in flat_paths(b["params"]).items()} == \
        {k: tuple(v.shape) for k, v in flat_paths(jb["params"]).items()}
    out = b["apply"](b["config"], params_from_numpy(params, "cpu"), {},
                     torch.from_numpy(mag))["enhanced_mag"]
    assert out.dtype == torch.float64 and out.shape == (2, 257, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-9, rtol=0)


def _jax_recipe_trainer():
    spec = importlib.util.spec_from_file_location("sdnn_delays_jax_trainer", RECIPE / "trainer.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Trainer


def test_one_recipe_update_matches_jax_value_and_grad_f64():
    args = dict(toml_load(RECIPE / "tiny_synthetic.toml")["model"]["args"])
    n_fft, hop, win = 256, 64, 256
    jb = JS.build(seed=1, **args)
    params = _f64(jb["params"])
    rng = np.random.default_rng(3)
    clean = rng.standard_normal((2, 4800)) * 0.1
    noisy = clean + rng.standard_normal((2, 4800)) * 0.05
    jself = SimpleNamespace(n_fft=n_fft, hop_length=hop, win_length=win, lam=0.001,
                            model_config=jb["config"], model_apply=jb["apply"])
    jtrainer = _jax_recipe_trainer()

    def jloss(p):
        loss, aux, _ = jtrainer.training_step_fn(jself, p, {}, (noisy, clean))
        return loss, aux

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    tp = params_from_numpy(params, "cpu")
    for t in jax.tree.leaves(tp):
        t.requires_grad_(True)
    losses, state = sdnn_loss(PS._apply, PS.SDNNConfig(**args), tp, {}, torch.from_numpy(noisy),
                              torch.from_numpy(clean), n_fft, hop, win)
    losses["loss"].backward()
    assert state == {}
    np.testing.assert_allclose(losses["loss"].item(), float(jl), rtol=1e-9)
    np.testing.assert_allclose(losses["si_snr"].item(), float(jaux["si_snr"]), rtol=1e-9)
    for (path, g), t in zip(jax.tree_util.tree_leaves_with_path(jg), jax.tree.leaves(tp)):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, atol=1e-9 * np.abs(g).max(), rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


def test_tiny_synthetic_through_the_cli(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    shutil.copy(RECIPE / "tiny_synthetic.toml", tmp_path / "tiny_synthetic.toml")

    def run(*argv):
        return cli.main(["-C", "tiny_synthetic.toml", *argv, "--device", "cpu"], recipe_dir=RECIPE)

    t = run("-M", "train")
    assert isinstance(t, SdnnDelaysTrainer) and t.state.epochs_trained == 1
    assert t.state.steps_trained == 2 and np.isfinite(t.state.best_score)
    cfg = toml_load(tmp_path / "tiny_synthetic.toml")
    cfg["trainer"]["args"]["max_epochs"] = 2
    from spiking_fullsubnet_torch.runtime.config import toml_dump
    toml_dump(cfg, tmp_path / "tiny_synthetic.toml")
    t = run("-M", "train", "-R")
    assert t.state.epochs_trained == 2 and t.state.steps_trained == 4
    run("-M", "test", "predict", "--ckpt_path", "best")
    exp = tmp_path / "exp" / "tiny_synthetic"
    means = sorted((exp / "metrics").glob("*_mean.csv"))
    assert means and means[-1].read_text().splitlines()[0].split(",")[0] == "si_sdr"
    assert sorted(p.name for p in (exp / "enhanced" / "dataloader_0").glob("*.wav")) == \
        ["synthetic_0.wav"]
    if not torch.cuda.is_available():  # the default device is cuda, never the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["-C", "tiny_synthetic.toml", "-M", "train"], recipe_dir=RECIPE)
