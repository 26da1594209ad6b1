"""The remaining models on a card: the shared sub-band ablation on kernels
F, D, E and dW at its own shapes, the SDNN with delays and FullSubNet.

Marked ``cuda``: they skip without an NVIDIA GPU. This file imports neither
JAX nor the JAX package (the CPU tests hold these modules against it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_models.py

- The shared sub-band at zoo M widths (bottleneck 224, random weights) on
  4 x 1 s: the eval forward launches F twice (the fullband, and the shared
  stack over 13 units x 4 rows) and nothing else; each launch against its
  plain version on the recorded arguments, spike mismatch < 1e-3 (the
  bound of ``chip_smoke.py`` phase 3).
- Its train step on 8 x 1 s: D, E and dW four launches each and nothing
  else, a finite loss and gradient; on the recorded arguments D's spikes
  on the first 16 frames within a mismatch of 1e-3 of its plain version
  (BN couples the rows, so a later rounding flip moves a whole layer), E
  within relative L2 1e-3 on them, dW within 1e-5 on identical inputs
  (``chip_smoke.py`` phase 6's limits).
- The SDNN at ``baseline.toml``'s widths (2 x 1 s) in float32 on the card
  against the same code in float64 on the card: the enhanced magnitude
  within relative L2 1e-2 (a delta on a rounding tie moves by a whole
  threshold step in one precision and not the other).
- FullSubNet at its published widths (3 x 1 s): the eval cIRM and the
  training cIRM (drop-band) in float32 against float64 on the card,
  relative L2 < 1e-4.
"""

from __future__ import annotations

import functools
from dataclasses import replace

import pytest
import torch

from spiking_fullsubnet_torch.models import fullsubnet, sdnn
from spiking_fullsubnet_torch.models.spiking_fullsubnet import (separator_config,
                                                                spiking_fullsubnet_apply,
                                                                spiking_fullsubnet_init)
from spiking_fullsubnet_torch.nn.core import tree_map
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.recipes.denoise import denoise_loss
from spiking_fullsubnet_torch.runtime.trainer import tensors_of

pytestmark = pytest.mark.cuda

COUNTED = {"A": "gsu_stack_eval", "B": "gsu_sections_eval", "C": "sfsb_monolith_serve",
           "F": "gsu_stack_eval_x", "D": "gsu_layer_train_fwd", "E": "gsu_layer_train_bwd",
           "dW": "gsu_train_dw"}
SDNN_ARGS = dict(threshold=0.1, max_delay=64, out_delay=0, input_size=257, hidden_size=512)
FULLSUBNET_ARGS = dict(num_freqs=257, look_ahead=2, sequence_model="LSTM", fb_num_neighbors=0,
                       sb_num_neighbors=15, fb_output_activate_function="ReLU",
                       sb_output_activate_function=False, fb_model_hidden_size=512,
                       sb_model_hidden_size=384, norm_type="offline_laplace_norm",
                       num_groups_in_drop_band=2)


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


def _recorded(names, run):
    """``run()`` with the wrappers ``names`` recorded: each call's arguments,
    detached. A wrapper counts its launches on the object its module's name
    holds, the recorder while it stands there: its count goes back to the
    wrapper after."""
    seen = {n: [] for n in names}
    real = {n: getattr(gk, n) for n in names}

    def rec(n):
        @functools.wraps(real[n])
        def wrapped(*a, **k):
            seen[n].append(tuple(t.detach() if isinstance(t, torch.Tensor) else t for t in a))
            return real[n](*a, **k)
        return wrapped

    recorders = {n: rec(n) for n in names}
    for n in names:
        setattr(gk, n, recorders[n])
    try:
        run()
    finally:
        for n in names:
            setattr(gk, n, real[n])
            real[n].launches = recorders[n].launches
    return seen


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def _noise(shape, dev, seed):
    g = torch.Generator().manual_seed(seed)
    clean = torch.randn(shape, generator=g) * 0.1
    return (clean + 0.05 * torch.randn(shape, generator=g)).to(dev), clean.to(dev)


def _shared(dev):
    cfg = replace(separator_config(norm_type="offline_laplace_norm", shared_weights=True, bn=True),
                  sb_shared_bottleneck=224)
    return cfg, *spiking_fullsubnet_init(0, cfg, device=dev)


def test_shared_subband_eval_launches_f_twice_at_its_shapes(dev):
    cfg, params, state = _shared(dev)
    noisy, _ = _noise((4, 16000), dev, 1)
    _zero()
    with torch.no_grad():
        seen = _recorded(["gsu_stack_eval_x"],
                         lambda: spiking_fullsubnet_apply(cfg, params, state, noisy))
        torch.cuda.synchronize()
        assert _counts() == dict({k: 0 for k in COUNTED}, F=2)
        args = seen["gsu_stack_eval_x"]
        assert [tuple(a[0].shape[1:]) for a in args] == [(4, 64), (4 * 13, 224)]
        for a in args:
            got, ref = gk.gsu_stack_eval_x(*a), gk.stack_eval_x_plain(*a)
            assert float((got != ref).float().mean()) < 1e-3


def test_shared_subband_train_step_on_d_e_and_dw(dev):
    cfg, params, state = _shared(dev)
    noisy, clean = _noise((8, 16000), dev, 2)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    box = {}

    def step():
        out = spiking_fullsubnet_apply(cfg, params, state, noisy, train=True)
        box["loss"] = denoise_loss(out["enhanced_y"], clean)["loss"]
        box["loss"].backward()

    _zero()
    seen = _recorded(["gsu_layer_train_fwd", "gsu_layer_train_bwd"], step)
    torch.cuda.synchronize()
    assert _counts() == dict({k: 0 for k in COUNTED}, D=4, E=4, dW=4)
    assert torch.isfinite(box["loss"])
    assert all(torch.isfinite(t.grad).all() for t in tensors_of(params))
    d_args, e_args = seen["gsu_layer_train_fwd"], seen["gsu_layer_train_bwd"]
    assert [tuple(a[0].shape[1:]) for a in d_args] == [(8, 320)] * 2 + [(8 * 13, 224)] * 2
    for da in d_args:
        head = (da[0][:16].contiguous(), *da[1:])
        got, ref = gk.gsu_layer_train_fwd(*head), gk.layer_train_fwd_plain(*head)
        assert float((got[0] != ref[0]).float().mean()) < 1e-3
    for ea in e_args:
        head = (*[t[:16].contiguous() for t in ea[:4]], *ea[4:])
        got, ref = gk.gsu_layer_train_bwd(*head), gk.layer_train_bwd_plain(*head)
        assert max(_rel(g, r) for g, r in zip(got, ref)) < 1e-3
        dxg = ref[0]
        assert _rel(gk.gsu_train_dw(head[1], dxg), gk.train_dw_plain(head[1], dxg)) < 1e-5


def test_sdnn_on_the_card_against_float64(dev):
    b = sdnn.build(seed=0, device=dev, **SDNN_ARGS)
    g = torch.Generator().manual_seed(3)
    mag = (torch.rand((2, 257, 126), generator=g) * 1.5).to(dev)
    with torch.no_grad():
        got = b["apply"](b["config"], b["params"], {}, mag)["enhanced_mag"]
        ref = b["apply"](b["config"], tree_map(lambda t: t.double(), b["params"]), {},
                         mag.double())["enhanced_mag"]
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _rel(got, ref) < 1e-2


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train_drop_band"])
def test_fullsubnet_on_the_card_against_float64(dev, train):
    b = fullsubnet.build(seed=0, device=dev, **FULLSUBNET_ARGS)
    g = torch.Generator().manual_seed(4)
    mag = torch.rand((3, 1, 257, 63), generator=g).to(dev)
    with torch.no_grad():
        got = b["apply"](b["config"], b["params"], {}, mag, train)["cirm"]
        ref = b["apply"](b["config"], tree_map(lambda t: t.double(), b["params"]), {},
                         mag.double(), train)["cirm"]
    assert got.shape == ((3, 2, 128, 63) if train else (3, 2, 257, 63))
    assert _rel(got, ref) < 1e-4
