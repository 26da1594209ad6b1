"""Serving on a card: the streaming step's CUDA graph, the eval kernels'
operators and the serving export.

Marked ``cuda``: they skip without an NVIDIA GPU. This file imports neither
JAX nor the JAX package (the CPU tests hold these modules against it):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_serving.py

- ``StreamingEnhancer.step`` (the CUDA graph) against ``eager_step`` at
  chunk_frames 1 and 4: every output and the final state equal bit for
  bit, the state given to a step left as it was, no kernel launched.
- ``torch.library.opcheck`` on the operators of kernels A, B, C and F, with
  the arguments of narrow models' forwards (the two-launch path, the
  monolith, the layered forward).
- The export round trips on the card: the offline graph on
  ``scan_mode="auto"`` (kernel C) and ``"fused"`` (kernel F) and the
  streaming step, saved, loaded and run equal to the live graph at atol 0;
  the loaded offline programs launch C once and F four times.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from spiking_fullsubnet_torch.models.presets import flagship_m
from spiking_fullsubnet_torch.models.spiking_fullsubnet import SpikingFullSubNet, separator_config
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.streaming import StreamingEnhancer, state_leaves
from spiking_fullsubnet_torch.tools import export_serving as es

pytestmark = pytest.mark.cuda

COUNTED = ("gsu_stack_eval", "gsu_sections_eval", "sfsb_monolith_serve", "gsu_stack_eval_x")
NARROW = dict(fb_hidden_size=32, sb_hidden_size=24, collect_layer_outputs=False)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _counts():
    return {name: getattr(gk, name).launches for name in COUNTED}


def _audio(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32)).to(dev)


@pytest.mark.parametrize("chunk_frames", [1, 4])
def test_graph_step_equals_eager_bitwise(dev, chunk_frames):
    b = flagship_m(seed=0, device=dev)
    enh = StreamingEnhancer(b["config"], b["params"], b["state"], batch_size=2,
                            chunk_frames=chunk_frames, device=dev)
    chunk = chunk_frames * b["config"].hop_length
    x = _audio((2, 48 * chunk), 3, dev)
    before = _counts()
    g_state = e_state = enh.init_state(prime_samples=x[:, :enh.prime_len])
    for i in range(0, x.shape[-1], chunk):
        c = x[:, i:i + chunk].contiguous()
        kept = [t.clone() for t in state_leaves(g_state)]
        g_new, g_y = enh.step(g_state, c)
        assert all(torch.equal(a, k) for a, k in zip(state_leaves(g_state), kept))
        e_state, e_y = enh.eager_step(e_state, c)
        g_state = g_new
        assert torch.equal(g_y, e_y)
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(g_state), state_leaves(e_state)))
    assert _counts() == before  # the stream launches none of the kernels


def test_operators_pass_opcheck(dev):
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "sfs_torch":  # eval operators: no autograd formula
                calls.append((func, tuple(a.detach() if isinstance(a, torch.Tensor) else a
                                          for a in args)))
            return func(*args, **(kwargs or {}))

    two_launch = replace(separator_config(norm_type="offline_laplace_norm", bn=True,
                                          shared_weights=True), scan_mode="auto", **NARROW)
    pre_ln = flagship_m(device="cpu", scan_mode="auto", **NARROW)["config"]
    x = _audio((2, 3000), 4, dev)
    with torch.no_grad(), Record():
        for cfg in (two_launch, pre_ln, replace(pre_ln, scan_mode="layered")):
            SpikingFullSubNet.from_init(cfg, seed=1, device=dev)(x)
    seen = {}
    for func, args in calls:
        seen.setdefault(func.name(), (func, args))
    assert sorted(n.split("::")[1].split(".")[0] for n in seen) == [
        "gsu_sections_eval", "gsu_stack_eval", "gsu_stack_eval_x", "sfsb_monolith_serve"]
    for func, args in seen.values():
        torch.library.opcheck(func, args)


@pytest.mark.parametrize("mode, want", [("auto", {"sfsb_monolith_serve": 1}),
                                        ("fused", {"gsu_stack_eval_x": 4})])
def test_offline_export_round_trip_launches_the_kernels(dev, tmp_path, mode, want):
    b = es.build_bundle(None, device=dev, scan_mode=mode, collect_layer_outputs=False)
    ep, example = es.export_offline(b, 2, 1.0, 16000)
    torch.export.save(ep, str(tmp_path / "offline.pt2"))
    x = _audio(tuple(example.shape), 5, dev)
    with torch.no_grad():
        live = es._Enhance(b)(x)
    before = _counts()
    es.roundtrip_check(tmp_path / "offline.pt2", (x,), live)
    after = _counts()
    assert {k: after[k] - before[k] for k in COUNTED if after[k] != before[k]} == want


def test_streaming_export_round_trip(dev, tmp_path):
    b = flagship_m(seed=0, device=dev)
    ep, enh, state, chunk = es.export_streaming(b, 1, 2)
    torch.export.save(ep, str(tmp_path / "step.pt2"))
    step = torch.export.load(str(tmp_path / "step.pt2")).module()
    x = _audio((1, 8 * chunk.shape[-1]), 6, dev)
    live = art = state
    for i in range(0, x.shape[-1], chunk.shape[-1]):
        c = x[:, i:i + chunk.shape[-1]].contiguous()
        live, y_live = enh.eager_step(live, c)
        art, y_art = step(art, c)
        assert torch.equal(y_art, y_live)
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(art), state_leaves(live)))
