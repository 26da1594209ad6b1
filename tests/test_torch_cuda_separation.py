"""The separation and dereverberation recipes' models on a card.

Marked ``cuda``: they skip without an NVIDIA GPU. This file imports neither
JAX nor the JAX package (the CPU tests hold these modules against it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_separation.py

- The two-speaker Spiking-FullSubNet at ``recipes/wsj0-mix/
  spiking_fullsubnet/default.toml``'s widths (n_fft 256, fb 320, sb 224,
  random weights) on a 1 x 4 s synthetic mixture: its eval route (the
  layered forward, kernel F four times and nothing else) against the fused
  plain version run on the card, spike mismatch per layer < 1e-3 and the
  audio within the spike-flip bound (relative L2 < 0.05), as in
  ``chip_smoke.py``.
- The launches at the recipes' shapes (n_fft 256 at 8 kHz, two speakers;
  REVERB's n_fft 512 at 16 kHz): a train step on 8 x 1 s launches D, E and
  dW eight times each and nothing else, with a finite loss and gradient; an
  eval batch F four times.
- Conv-TasNet (``base = true``) and cIRM-LSTM at their recipes' widths on
  the card against the same forward on the CPU, TF32 off, float32: the
  separated audio within a relative L2 of 1e-4 (float32 sums in another
  order through 24 blocks, or 502 LSTM steps).
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from spiking_fullsubnet_torch.data.wsj0_mix import SyntheticMixDataset
from spiking_fullsubnet_torch.losses.pit import pairwise_neg_sisdr, pit_wrapper
from spiking_fullsubnet_torch.models import cirm_models, conv_tasnet
from spiking_fullsubnet_torch.models.fused_forward import fused_forward_plain
from spiking_fullsubnet_torch.models.spiking_fullsubnet import build, spiking_fullsubnet_apply
from spiking_fullsubnet_torch.nn.core import tree_map
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.runtime.config import toml_load
from spiking_fullsubnet_torch.runtime.trainer import tensors_of

pytestmark = pytest.mark.cuda

RECIPES = Path(__file__).resolve().parent.parent / "recipes"
WSJ0 = RECIPES / "wsj0-mix"
COUNTED = {"A": "gsu_stack_eval", "B": "gsu_sections_eval", "C": "sfsb_monolith_serve",
           "F": "gsu_stack_eval_x", "D": "gsu_layer_train_fwd", "E": "gsu_layer_train_bwd",
           "dW": "gsu_train_dw"}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    return {k: getattr(gk, name).launches for k, name in COUNTED.items()}


def _zero():
    for name in COUNTED.values():
        getattr(gk, name).launches = 0


def _launches(**kw):
    return {k: kw.get(k, 0) for k in COUNTED}


def _model(toml, dev):
    cfg = toml_load(toml)
    return build(seed=cfg["meta"]["seed"], device=dev, **cfg["model"]["args"]), cfg


def _mixtures(batch, seconds, sr, dev):
    ds = SyntheticMixDataset(num_samples=batch, duration=seconds, sr=sr, seed=3)
    mix, ref, _ = zip(*(ds[i] for i in range(batch)))
    return torch.from_numpy(np.stack(mix)).to(dev), torch.from_numpy(np.stack(ref)).to(dev)


def _mismatch(a, b):
    return float((a != b).float().mean())


def test_two_speaker_eval_route_against_its_fused_plain_version(dev):
    bundle, _ = _model(WSJ0 / "spiking_fullsubnet" / "default.toml", dev)
    cfg, params, state = bundle["config"], bundle["params"], bundle["state"]
    assert cfg.num_spks == 2 and cfg.scan_mode == "layered" and cfg.fb_hidden_size == 320
    x, _ = _mixtures(1, 4.0, 8000, dev)
    with torch.no_grad():
        _zero()
        out = spiking_fullsubnet_apply(cfg, params, state, x)
        torch.cuda.synchronize()
        assert _counts() == _launches(F=4)
        plain = fused_forward_plain(replace(cfg, scan_mode="fused"), params, state, x)

    def spikes(o):
        return ([o["fb_all_layer_outputs"][k] for k in (1, 2)]
                + [sec[k] for sec in o["sb_all_layer_outputs"] for k in (1, 2)])

    mism = [_mismatch(a, b) for a, b in zip(spikes(out), spikes(plain))]
    assert len(mism) == 8 and max(mism) < 1e-3, mism
    got, ref = out["enhanced_y"], plain["enhanced_y"]
    assert got.shape == (1, 2, 32000) and bool(torch.isfinite(got).all())
    assert float((got - ref).norm() / ref.norm()) < 0.05


@pytest.mark.parametrize("toml,sr", [(WSJ0 / "spiking_fullsubnet" / "default.toml", 8000),
                                     (RECIPES / "reverb" / "spiking_fullsubnet" / "default.toml",
                                      16000)], ids=["wsj0_mix", "reverb"])
def test_launch_counts_at_the_recipe_shapes(dev, toml, sr):
    bundle, _ = _model(toml, dev)
    cfg, params, state = bundle["config"], bundle["params"], bundle["state"]
    mix, ref = _mixtures(8, 1.0, sr, dev)
    if cfg.num_spks == 1:
        ref = ref.sum(1) * 0.5
    leaves = tensors_of(params)
    for t in leaves:
        t.requires_grad_(True)
    _zero()
    out = spiking_fullsubnet_apply(cfg, params, state, mix, train=True)
    est = out["enhanced_y"]
    loss = (pit_wrapper(pairwise_neg_sisdr, est, ref)[0] if cfg.num_spks > 1
            else (est - ref).abs().mean())
    loss.backward()
    torch.cuda.synchronize()
    assert _counts() == _launches(D=8, E=8, dW=8)
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(t.grad).all()) for t in leaves)
    with torch.no_grad():
        _zero()
        spiking_fullsubnet_apply(cfg, params, state, mix[:1])
        torch.cuda.synchronize()
    assert _counts() == _launches(F=4)


@pytest.mark.parametrize("recipe", ["conv_tasnet", "cirm_lstm"])
def test_baseline_on_the_card_equals_the_cpu(dev, recipe):
    cfg = toml_load(WSJ0 / recipe / "default.toml")
    module = conv_tasnet if recipe == "conv_tasnet" else cirm_models
    bundle = module.build(seed=cfg["meta"]["seed"], device="cpu", **cfg["model"]["args"])
    mix, _ = _mixtures(2, 4.0, 8000, "cpu")
    with torch.no_grad():
        ref = bundle["apply"](bundle["config"], bundle["params"], bundle["state"], mix)
        _zero()
        out = bundle["apply"](bundle["config"], tree_map(lambda t: t.to(dev), bundle["params"]),
                              tree_map(lambda t: t.to(dev), bundle["state"]), mix.to(dev))
        torch.cuda.synchronize()
    assert _counts() == _launches()  # the JAX package has no Pallas kernel on these models
    got, want = out["enhanced_y"].cpu(), ref["enhanced_y"]
    assert got.shape == want.shape == (2, 2, 32000)
    assert float((got - want).norm() / want.norm()) < 1e-4
