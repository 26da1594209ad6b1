"""The flagship recipes' modules on a card: the fused forward's kernel route,
the MetricGAN discriminator and the GAN trainer through the CLI.

Marked ``cuda``: they skip without an NVIDIA GPU. This file imports neither
JAX nor the JAX package (the CPU tests hold these modules against it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_recipes.py

- ``scan_mode="fused"`` on a CUDA tensor runs the layered formulation on
  the kernels: equal to ``scan_mode="layered"`` bit for bit, in eval (F
  four launches) and in training (D, E and dW eight each, the gradients
  too); in eval and training, also at ``fb_proj_size=0`` (a fullband tile
  of 128 bins, where the layered forward's answer is another), its spikes
  against the fused plain version run on the card (mismatch < 1e-3 per
  layer), the audio within the spike-flip bound (relative L2 < 0.05), as in
  ``chip_smoke.py``.
- The discriminator on the card in float32 against the same weights on the
  CPU in float64, two passes in training: the scores, ``u`` and ``v``
  within 1e-4.
- ``tiny_synthetic_GAN.toml`` through ``runtime.cli`` on the card: one
  epoch, then ``-R`` with a second; finite losses, D, E and dW eight
  launches an update, F four a validation batch, the discriminator's
  weights moved and restored on resume.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import pytest
import torch

from spiking_fullsubnet_torch.models import discriminator as PD
from spiking_fullsubnet_torch.models.fused_forward import fused_forward_plain
from spiking_fullsubnet_torch.models.spiking_fullsubnet import (SpikingFullSubNetConfig,
                                                                 spiking_fullsubnet_apply,
                                                                 spiking_fullsubnet_init)
from spiking_fullsubnet_torch.nn.core import tree_map
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.runtime.trainer import tensors_of

pytestmark = pytest.mark.cuda

RECIPES = Path(__file__).resolve().parent.parent / "recipes" / "intel_ndns"
COUNTED = ("gsu_stack_eval", "gsu_sections_eval", "sfsb_monolith_serve", "gsu_stack_eval_x",
           "gsu_layer_train_fwd", "gsu_layer_train_bwd", "gsu_train_dw")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    return {name: getattr(gk, name).launches for name in COUNTED}


def _zero():
    for name in COUNTED:
        getattr(gk, name).launches = 0


def _small(dev, **change):
    cfg = SpikingFullSubNetConfig(fb_hidden_size=32, sb_hidden_size=24, df_orders=(2, 1, 1),
                                  bn=True, shared_weights=True, scan_mode="fused", **change)
    params, state = spiking_fullsubnet_init(0, cfg, device=dev)
    g = torch.Generator().manual_seed(1)
    x = (torch.randn(8, 4000, generator=g) * 0.1).to(dev)
    return cfg, params, state, x


@pytest.mark.parametrize("change", [{}, {"fb_proj_size": 0}], ids=["small", "fb_proj_size_0"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fused_route_equals_layered_and_its_plain_version(dev, train, change):
    cfg, params, state, x = _small(dev, **change)
    with torch.set_grad_enabled(train):
        _zero()
        out = spiking_fullsubnet_apply(cfg, params, state, x, train=train)
        torch.cuda.synchronize()
        want = ({"gsu_layer_train_fwd": 8, "gsu_layer_train_bwd": 0, "gsu_train_dw": 0}
                if train else {"gsu_stack_eval_x": 4})
        assert _counts() == dict.fromkeys(COUNTED, 0) | want
        lay = spiking_fullsubnet_apply(replace(cfg, scan_mode="layered"), params, state, x,
                                       train=train)
        plain = fused_forward_plain(cfg, params, state, x, train=train)
    if not change:  # at fb_proj_size=0 the layered forward's tile gives another answer
        for a, b in zip(tensors_of([out["enhanced_y"], out["fb_all_layer_outputs"],
                                    out["sb_all_layer_outputs"]]),
                        tensors_of([lay["enhanced_y"], lay["fb_all_layer_outputs"],
                                    lay["sb_all_layer_outputs"]])):
            assert torch.equal(a, b)
    spikes = lambda o: ([o["fb_all_layer_outputs"][k] for k in (1, 2)]  # noqa: E731
                        + [sec[k] for sec in o["sb_all_layer_outputs"] for k in (1, 2)])
    for a, b in zip(spikes(out), spikes(plain)):
        assert (a != b).float().mean().item() < 1e-3
    rel = ((out["enhanced_y"] - plain["enhanced_y"]).norm()
           / plain["enhanced_y"].norm()).item()
    assert rel < 0.05  # the spike-flip bound of tests/test_tpu_kernels.py:242


def test_fused_route_trains_as_layered(dev):
    cfg, params, state, x = _small(dev)
    target = torch.roll(x, 7, dims=-1) * 0.5
    results = []
    for c in (cfg, replace(cfg, scan_mode="layered")):
        p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
        _zero()
        out = spiking_fullsubnet_apply(c, p, state, x, train=True)
        (out["enhanced_y"] - target).abs().mean().backward()
        torch.cuda.synchronize()
        results.append((_counts(), out, [t.grad for t in tensors_of(p)]))
    (c_f, out_f, g_f), (c_l, out_l, g_l) = results
    assert c_f == c_l == dict.fromkeys(COUNTED, 0) | dict.fromkeys(
        ("gsu_layer_train_fwd", "gsu_layer_train_bwd", "gsu_train_dw"), 8)
    assert torch.equal(out_f["enhanced_y"], out_l["enhanced_y"])
    for a, b in zip(tensors_of(out_f["state"]), tensors_of(out_l["state"])):
        assert torch.equal(a, b)
    for a, b in zip(g_f, g_l):
        assert torch.equal(a, b)
    assert all(bool(torch.isfinite(g).all()) for g in g_f)


def test_discriminator_on_the_card_matches_float64(dev):
    params = PD.discriminator_init(torch.Generator().manual_seed(0), ndf=16)
    g = torch.Generator().manual_seed(2)
    clean = torch.randn(4, 257, 120, generator=g).abs()
    est = clean + 0.3 * torch.randn(4, 257, 120, generator=g).abs()
    ref = tree_map(lambda t: t.double(), params)
    got = tree_map(lambda t: t.to(dev), params)
    for _ in range(2):
        rs, ref = PD.discriminator_apply(ref, clean.double(), est.double(), train=True)
        gs, got = PD.discriminator_apply(got, clean.to(dev), est.to(dev), train=True)
        torch.testing.assert_close(gs.cpu().double(), rs, rtol=1e-4, atol=1e-4)
        for a, b in zip(tensors_of(got), tensors_of(ref)):
            torch.testing.assert_close(a.cpu().double(), b, rtol=1e-4, atol=1e-4)


def test_gan_recipe_trains_and_resumes_through_the_cli(dev, tmp_path, monkeypatch):
    from spiking_fullsubnet_torch.recipes import gan
    from spiking_fullsubnet_torch.runtime import cli
    from spiking_fullsubnet_torch.runtime.config import toml_dump, toml_load

    monkeypatch.chdir(tmp_path)
    recipe = RECIPES / "spiking_fullsubnet"
    cfg = toml_load(recipe / "tiny_synthetic_GAN.toml")
    cfg["train_dataset"]["args"]["num_samples"] = 16  # BN over 8 rows, two updates
    cfg["train_dataset"]["dataloader"]["batch_size"] = 8
    toml_dump(cfg, tmp_path / "gan.toml")
    updates, evals = [], []
    real_step = gan.GanDenoiseTrainer.generator_step
    real_val = gan.GanDenoiseTrainer.validation_step

    def generator_step(self, *a):
        _zero()
        out = real_step(self, *a)
        torch.cuda.synchronize()
        updates.append((out[0], _counts()))
        return out

    def validation_step(self, *a):
        torch.cuda.synchronize()
        before = _counts()
        out = real_val(self, *a)
        torch.cuda.synchronize()
        evals.append({k: v - before[k] for k, v in _counts().items()})
        return out

    monkeypatch.setattr(gan.GanDenoiseTrainer, "generator_step", generator_step)
    monkeypatch.setattr(gan.GanDenoiseTrainer, "validation_step", validation_step)
    t = cli.main(["-C", "gan.toml", "-M", "train"], recipe_dir=recipe)
    assert t.state.epochs_trained == 1 and len(updates) == 2 and t.device.type == "cuda"
    train = dict.fromkeys(COUNTED, 0) | dict.fromkeys(
        ("gsu_layer_train_fwd", "gsu_layer_train_bwd", "gsu_train_dw"), 8)
    assert all(c == train for _, c in updates)
    assert all(bool(torch.isfinite(v)) for losses, _ in updates for v in losses.values())
    assert evals and all(e == dict.fromkeys(COUNTED, 0) | {"gsu_stack_eval_x": 4}
                         for e in evals)
    init = PD.build(seed=cfg["meta"]["seed"] + 1, ndf=8, device=dev)["params"]
    assert not torch.equal(init["fc1"]["weight"], t.disc_params["d"]["fc1"]["weight"])
    saved = [w.detach().clone() for w in PD.discriminator_weights(t.disc_params["d"])]

    cfg["trainer"]["args"]["max_epochs"] = 2
    toml_dump(cfg, tmp_path / "gan.toml")
    seen = []
    real_d = gan.GanDenoiseTrainer.discriminator_step

    def discriminator_step(self, name, *a):
        if not seen:
            seen.append([w.detach().clone() for w in PD.discriminator_weights(
                self.disc_params[name])])
        return real_d(self, name, *a)

    monkeypatch.setattr(gan.GanDenoiseTrainer, "discriminator_step", discriminator_step)
    t2 = cli.main(["-C", "gan.toml", "-M", "train", "-R"], recipe_dir=recipe)
    assert t2.state.epochs_trained == 2 and len(updates) == 4
    for a, b in zip(seen[0], saved):
        assert torch.equal(a, b)
    assert all(c == train for _, c in updates)
