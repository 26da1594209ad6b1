"""The port's serving export (``spiking_fullsubnet_torch/tools/
export_serving.py``) on the CPU, and the eval kernels' operators.

As ``tests/test_export_serving.py`` does for ``jax.export``: export ->
``.pt2`` on disk -> ``torch.export.load`` -> run, equal to the live graph at
atol 0 (on the CPU the graphs hold the kernels' plain versions), for the
offline forward on ``scan_mode="layered"`` and ``"fused"`` and for the
streaming step threaded over several steps; the manifest's fields; the
initial state's ``.npz`` rebuilding the step's state. The operators
(``sfs_torch::*``, CUDA only) are reached here through their fake versions
on meta tensors: the output shapes they give from the launch arguments'
integers.
"""

from __future__ import annotations

import json
from dataclasses import replace

import numpy as np
import pytest
import torch

from spiking_fullsubnet_torch.models import stream_forward as sf
from spiking_fullsubnet_torch.models.spiking_fullsubnet import (SpikingFullSubNet,
                                                                 separator_config)
from spiking_fullsubnet_torch.nn.core import tree_map
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.runtime.convert import load_npz
from spiking_fullsubnet_torch.streaming import state_leaves, state_paths
from spiking_fullsubnet_torch.tools import export_serving as es

TINY = dict(fb_hidden_size=16, sb_hidden_size=8, fb_num_layers=1, sb_num_layers=1,
            df_orders=[2, 1, 1])


def _bundle(scan_mode="layered"):
    return es.build_bundle(None, device="cpu", scan_mode=scan_mode, collect_layer_outputs=False,
                           **TINY)


def _audio(shape, seed):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32))


@pytest.mark.parametrize("scan_mode", ["layered", "fused"])
def test_offline_export_round_trip(tmp_path, scan_mode):
    b = _bundle(scan_mode)
    exported, example = es.export_offline(b, batch=2, seconds=0.05, sr=16000)
    assert tuple(example.shape) == (2, 800)
    path = tmp_path / "enhance.pt2"
    torch.export.save(exported, str(path))
    assert path.stat().st_size > 1000
    x = _audio((2, 800), 0)
    with torch.no_grad():
        ref = b["apply"](b["config"], b["params"], b["state"], x)["enhanced_y"]
    es.roundtrip_check(path, (x,), ref)  # atol 0


def test_streaming_export_round_trip_multi_step(tmp_path):
    exported, enhancer, state, chunk = es.export_streaming(_bundle(), batch=1, chunk_frames=2)
    path = tmp_path / "step.pt2"
    torch.export.save(exported, str(path))
    restored = torch.export.load(str(path)).module()
    st_live = st_art = state
    for k in range(4):  # the state threads through the artifact
        c = _audio(tuple(chunk.shape), 1 + k)
        st_live, y_live = enhancer.eager_step(st_live, c)
        st_art, y_art = restored(st_art, c)
        assert torch.equal(y_art, y_live)
    for a, b in zip(state_leaves(st_art), state_leaves(st_live), strict=True):
        assert torch.equal(a, b)


def test_cli_writes_artifacts_manifest_and_init_state(tmp_path, monkeypatch):
    orig = es.build_bundle
    # tiny widths, overridden by whatever main() forwards (scan_mode, device, ...)
    monkeypatch.setattr(es, "build_bundle", lambda npz=None, **kw: orig(npz, **{**TINY, **kw}))
    out = tmp_path / "exported"
    manifest = es.main(["-O", str(out), "--batch", "1", "--seconds", "0.05",
                        "--chunk_frames", "1", "--device", "cpu", "--check"])
    assert json.loads((out / "manifest.json").read_text()) == manifest
    assert manifest["hop_length"] == 128 and manifest["n_fft"] == 512
    assert manifest["platforms"] == ["cpu"] and manifest["torch_version"] == torch.__version__
    assert manifest["requires"] == "spiking_fullsubnet_torch.ops.gsu_kernels"
    assert manifest["weights"] == "fresh-init"
    for kind in ("offline", "streaming"):
        art = manifest["artifacts"][kind]
        f = out / art["file"]
        assert f.exists() and f.stat().st_size == art["bytes"]
    assert manifest["artifacts"]["offline"]["file"] == "enhance_b1_t800.pt2"
    assert manifest["artifacts"]["offline"]["scan_mode"] == "fused"
    stream = manifest["artifacts"]["streaming"]
    assert stream["latency_budget_ms"] == pytest.approx(8.0) and stream["chunk_samples"] == 128

    # the init state's .npz nests back into the step's state, which the artifact takes
    b = orig(None, device="cpu", scan_mode="fused", collect_layer_outputs=False, **TINY)
    _, enhancer, state, chunk = es.export_streaming(b, 1, 1)
    assert [leaf["path"] for leaf in stream["init_state_leaves"]] == state_paths(state)
    assert [leaf["shape"] for leaf in stream["init_state_leaves"]] == [
        list(t.shape) for t in state_leaves(state)]
    shipped = load_npz(str(out / stream["init_state_file"]), device="cpu")
    assert state_paths(shipped) == state_paths(state)
    for a, b_ in zip(state_leaves(shipped), state_leaves(state), strict=True):
        assert torch.equal(a, b_)
    step = torch.export.load(str(out / stream["file"])).module()
    c = _audio(tuple(chunk.shape), 9)
    st_art, y_art = step(shipped, c)
    st_live, y_live = enhancer.eager_step(state, c)
    assert torch.equal(y_art, y_live)


def _meta(tree):
    return tree_map(lambda t: t.to("meta") if isinstance(t, torch.Tensor) else t, tree)


def _recorded(monkeypatch, name, run):
    """The arguments of each call of ``stream_forward.<name>`` while ``run``."""
    seen, real = [], getattr(sf, name)
    monkeypatch.setattr(sf, name, lambda *a, **k: seen.append(a) or real(*a, **k))
    run()
    return seen


def test_operators_fake_versions_give_the_kernels_output_shapes(monkeypatch):
    # A and F: the stack operators over meta tensors
    T, R, H, L = 5, 3, 16, 2
    wihr, whh, coef = torch.randn(L - 1, H, H), torch.randn(L, H, H), torch.randn(L, 4, H)
    flat, table = gk.stack_pack(wihr, whh, H, True)
    for collect, shape in ((True, (L, T, R, H)), (False, (T, R, H))):
        x = torch.empty(T, R, H, device="meta")
        out = gk._stack_launch("A", x, flat.to("meta"), table, coef.to("meta"), H, True,
                               gk.stack_x_plan(R, H, H, L, True, torch.float32), collect)
        assert out.device.type == "meta" and tuple(out.shape) == shape
    x = torch.empty(T, R, 7, device="meta")
    wih0 = torch.randn(7, H)
    flat, table = gk.stack_x_pack(wih0, wihr, whh, H, True)
    out = gk._stack_launch("F", x, flat.to("meta"), table, coef.to("meta"), H, True,
                           gk.stack_x_plan(R, 7, H, L, True, torch.float32))
    assert tuple(out.shape) == (L, T, R, H)

    # B and C: the launch arguments of tiny models' forwards on the CPU, on meta tensors
    two_launch = replace(separator_config(norm_type="offline_laplace_norm", bn=True,
                                          shared_weights=True, fb_hidden_size=16,
                                          sb_hidden_size=8),
                         scan_mode="auto", collect_layer_outputs=False)
    noisy = _audio((2, 1000), 3)
    m = SpikingFullSubNet.from_init(two_launch, seed=0, device="cpu")
    secs, xa, xb, alpha, spec_re, spec_im, hidden, shared, *beta = _recorded(
        monkeypatch, "gsu_sections_eval", lambda: m(noisy))[0]
    T, B = xa.shape[:2]
    W = sum(int(s["wa"].shape[0]) * s["ctr"] for s in secs)
    plan = gk.sections_plan(gk._sec_dims(secs, xb.shape[-1], hidden, shared), B, xa.dtype)
    re, im = gk._sections_launch(_meta(secs), *_meta([xa, xb, alpha, spec_re, spec_im]), hidden,
                                 shared, beta[0] if beta else None, plan)
    assert tuple(re.shape) == tuple(im.shape) == (T, B, W) and re.device.type == "meta"

    mono_cfg = replace(_bundle("auto")["config"], scan_mode="auto")
    m = SpikingFullSubNet.from_init(mono_cfg, seed=0, device="cpu")
    mono, chunks = _recorded(monkeypatch, "sfsb_monolith_serve", lambda: m(noisy))[0]
    args, inputs, _ = gk._mono_launch_args(_meta(mono), chunks.to("meta"))
    words = gk.struct_words(args)
    assert bytes(gk._struct_from(type(args), words)) == bytes(args)
    out = torch.ops.sfs_torch.sfsb_monolith_serve(*(inputs[k] for k in gk._MONO_IN), words)
    S = chunks.shape[0] - 3
    assert tuple(out.shape) == (S, 2, 128) and out.dtype == torch.float32
    assert gk.sfsb_monolith_serve.launches == gk.gsu_sections_eval.launches == 0
