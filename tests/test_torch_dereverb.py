"""The port's REVERB dereverberation recipe against the JAX package.

- ``data.ScpDataset`` and the recipe's four datasets (the port's copy of
  ``recipes/reverb/spiking_fullsubnet/dataloader.py``,
  ``recipes/reverb_data.py``) on scp data written to a temporary directory,
  item for item equal to the JAX ones (the training crops under the same
  numpy seed);
- the dereverb loss (freq_mae + mag_mae + L1, ``recipes/dereverb.py:45-58``)
  and its gradient against the JAX package's in float64, within 1e-10;
- ``reverb/spiking_fullsubnet/tiny_synthetic.toml`` through the port's CLI
  on the CPU: train, then predict on ``best``, the enhanced wavs mirroring
  the ``far_test`` tree (as tests/test_recipes_e2e.py:67-74 checks the JAX
  recipe); a recipe-local path the port has no copy of raises.
"""

from __future__ import annotations

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.data import ScpDataset as JaxScpDataset
from spiking_fullsubnet_tpu.losses import freq_mae, l1_loss, mag_mae

from spiking_fullsubnet_torch.data import ScpDataset
from spiking_fullsubnet_torch.dsp.io import save_wav
from spiking_fullsubnet_torch.recipes import reverb_data
from spiking_fullsubnet_torch.recipes.dereverb import DereverbTrainer, dereverb_loss
from spiking_fullsubnet_torch.runtime import cli

REVERB = Path(__file__).resolve().parent.parent / "recipes" / "reverb" / "spiking_fullsubnet"


def _jax_recipe_datasets():
    """The recipe directory's own dataloader.py (it imports the JAX package)."""
    spec = importlib.util.spec_from_file_location("reverb_dataloader", REVERB / "dataloader.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _write_reverb_data(root: Path, n: int = 4, samples: int = 6400):
    """tests/test_recipes_e2e.py:43-62's layout: wav/far_test/*_ch1.wav,
    wav/cln_test/*.wav and data/*.scp, the paths relative to ``root``."""
    rng = np.random.default_rng(0)
    (root / "data").mkdir()
    far, cln = root / "wav" / "far_test", root / "wav" / "cln_test"
    far.mkdir(parents=True)
    cln.mkdir(parents=True)
    rvb, dry = [], []
    for i in range(n):
        y = rng.standard_normal(samples).astype(np.float32) * 0.1
        save_wav(y + 0.3 * np.roll(y, 80), far / f"utt{i}_ch1.wav", 16000)
        save_wav(y, cln / f"utt{i}.wav", 16000)
        rvb.append(f"utt{i} wav/far_test/utt{i}_ch1.wav")
        dry.append(f"utt{i} wav/cln_test/utt{i}.wav")
    (root / "data" / "tr_simu_1ch.scp").write_text("\n".join(rvb))
    (root / "data" / "tr_cln.scp").write_text("\n".join(dry))
    (root / "data" / "et_simu_1ch.scp").write_text("\n".join(rvb[:2]))
    (root / "data" / "et_cln.scp").write_text("\n".join(dry[:2]))
    (root / "data" / "noisy.scp").write_text("\n".join(r.split()[1] for r in rvb))
    (root / "data" / "clean.scp").write_text("\n".join(d.split()[1] for d in dry))


def _same_items(port, ref, seed):
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        np.random.seed(seed + i)
        want = ref[i]
        np.random.seed(seed + i)
        got = port[i]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, str):
                assert g == w
            else:
                assert g.dtype == np.float32
                np.testing.assert_array_equal(g, w)


def test_datasets_equal_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _write_reverb_data(tmp_path)
    for kw in (dict(sublen=0.2, offset=1, limit=2), dict(train=False), {}):
        _same_items(ScpDataset("data/noisy.scp", "data/clean.scp", **kw),
                    JaxScpDataset("data/noisy.scp", "data/clean.scp", **kw), 5)
    _same_items(ScpDataset("data/noisy.scp"), JaxScpDataset("data/noisy.scp"), 5)

    jd = _jax_recipe_datasets()
    cases = [("EvaluationRealDataset", ("data/et_simu_1ch.scp",), {}),
             ("EvaluationSimDataset", ("data/tr_simu_1ch.scp",), {}),
             ("SimTrainDataset", ("data/tr_simu_1ch.scp", "data/tr_cln.scp"),
              dict(duration_in_seconds=0.3)),
             ("SimTrainDataset", ("data/tr_simu_1ch.scp", "data/tr_cln.scp"),
              dict(duration_in_seconds=0.3, offset=1, limit=2)),
             ("SimDTDataset", ("data/et_simu_1ch.scp", "data/et_cln.scp"), {}),
             ("SimDTDataset", ("data/tr_simu_1ch.scp", "data/tr_cln.scp"), dict(offset=1, limit=2))]
    for name, args, kw in cases:
        _same_items(getattr(reverb_data, name)(*args, **kw), getattr(jd, name)(*args, **kw), 9)
    rvb, dry, utt = reverb_data.SimDTDataset("data/et_simu_1ch.scp", "data/et_cln.scp")[1]
    assert utt == "utt1" and rvb.shape == dry.shape == (6400,)


def test_dereverb_loss_matches_jax_f64():
    rng = np.random.default_rng(3)
    est, ref = rng.standard_normal((2, 6000)) * 0.1, rng.standard_normal((2, 6000)) * 0.1

    def jloss(e):
        e, r = jnp.asarray(e), jnp.asarray(ref)
        return freq_mae(e, r) + mag_mae(e, r) + l1_loss(e, r)

    jval, jgrad = jax.value_and_grad(jloss)(jnp.asarray(est))
    e = torch.from_numpy(est).requires_grad_(True)
    losses = dereverb_loss(e, torch.from_numpy(ref))
    assert sorted(losses) == ["loss", "loss_freq_mae", "loss_mag_mae", "loss_time_mae"]
    np.testing.assert_allclose(losses["loss"].item(), float(jval), atol=1e-10, rtol=0)
    np.testing.assert_allclose(losses["loss_time_mae"].item(),
                               float(l1_loss(jnp.asarray(est), jnp.asarray(ref))), atol=1e-12)
    losses["loss"].backward()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(jgrad), atol=1e-10, rtol=0)


def test_cli_train_then_predict_mirrors_the_tree(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    shutil.copy(REVERB / "tiny_synthetic.toml", tmp_path / "tiny_synthetic.toml")
    _write_reverb_data(tmp_path)

    def run(*argv):
        return cli.main(["-C", "tiny_synthetic.toml", *argv, "--device", "cpu"], recipe_dir=REVERB)

    t = run("-M", "train")
    assert type(t) is DereverbTrainer and t.north_star_metric == "si_sdr"
    assert t.state.epochs_trained == 1 and t.state.steps_trained == 2
    exp = tmp_path / "exp" / "tiny_synthetic"
    assert (exp / "checkpoints" / "best").exists()
    assert np.isfinite(t.state.best_score)
    run("-M", "predict", "--ckpt_path", "best")
    out = exp / "enhanced" / "dataloader_0" / "far_test"
    assert sorted(p.name for p in out.glob("*.wav")) == ["utt0_ch1.wav", "utt1_ch1.wav"]

    assert cli.recipe_path("dataloader.SimDTDataset", REVERB) == \
        "spiking_fullsubnet_torch.recipes.reverb_data.SimDTDataset"
    assert cli.recipe_path("spiking_fullsubnet_tpu.data.ScpDataset", REVERB) == \
        "spiking_fullsubnet_tpu.data.ScpDataset"
    with pytest.raises(NotImplementedError, match="remaining models and recipes"):
        cli.recipe_path("my_loader.Dataset", REVERB)
