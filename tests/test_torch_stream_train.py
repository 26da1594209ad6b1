"""The port's training on the stream path against the JAX package.

On the CPU the JAX stream forward trains through its scan (``_stack_train_xg``
with ``use_pallas`` False), or, with ``gsu_pallas._INTERPRET`` set and the
bf16 policy, through ``gsu_layer_pallas_train_padded`` in interpret mode
with bf16 streams. The port runs its own stream-train glue with the plain
versions of kernels D and E.

- one whole training step (apply(train=True) with scan_mode="stream", the
  denoise recipe's loss, its gradient, clipping by global norm 10, AdamW)
  in f64 against the JAX stream forward's value_and_grad: flagship M at full
  width (random JAX weights, pre-LN on both stacks), zoo M from
  baseline_m.npz (offline laplace norm) and a tiny zoo-like config with the
  cumulative laplace norm (tests/test_stream_forward.py:248-281), 8 rows
  (BN over 2-4 rows of one utterance explodes the first fullband layer's
  gradient). The tolerances are tests/test_stream_forward.py:129-137's:
  loss and enhanced_y within 1e-6 and 3e-6, the new BN state within 1e-9,
  every gradient leaf within 1e-6;
- inside the port, f64: the stream path's loss, state and gradients against
  the layered path's, at the same tolerances;
- the bf16 policy, tiny flagship-like widths: the port's stream step against
  the JAX stream step on its Pallas kernels in interpret mode (bf16
  streams), with tests/test_stream_forward.py:144-179's bounds (loss within
  2e-4 relative, global gradient relative L2 < 0.25). The JAX side runs its
  DFTs as bf16 matmuls (DFT_MODE "matmul", as on its chip; on a CPU it
  would take the FFT at full precision) and is compiled without XLA's
  excess precision, so that its bf16 values are rounded where its code
  rounds them, as eager JAX and PyTorch do: jitted with excess precision
  its loss moves by 7e-4 from its own eager value;
- the dispatch: on a CPU tensor "stream" with train=True runs the plain
  versions of D and E; with collect_layer_outputs=True it also returns the
  synops lists (f64 values against the JAX stream forward's, atol 1e-9).
The layer-level bf16 checks of D and E are in test_torch_train_layer.py.
Inputs are made with numpy from a seed and handed to both packages.
"""

from __future__ import annotations

from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import spiking_fullsubnet_tpu.ops.gsu_pallas as gp
from spiking_fullsubnet_tpu.dsp import spectral as JSP
from spiking_fullsubnet_tpu.losses import freq_mae, mag_mae, si_snr
from spiking_fullsubnet_tpu.models import spiking_fullsubnet as J
from spiking_fullsubnet_tpu.models.presets import flagship_m as jax_flagship_m
from spiking_fullsubnet_tpu.runtime.convert import load_npz as jax_load_npz

from spiking_fullsubnet_torch.models import spiking_fullsubnet as P
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.recipes.denoise import adamw, train_step
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy

ZOO_M = Path(__file__).resolve().parent.parent / "model_zoo/intel_ndns/spike_fsb/baseline_m.npz"
ZOO_KW = dict(norm_type="offline_laplace_norm", shared_weights=True, bn=True)
# tests/test_stream_forward.py:248-263, the cumulative laplace norm
ZOO_LIKE = dict(
    n_fft=128, hop_length=32, win_length=128,
    fb_input_size=16, fb_hidden_size=24, fb_proj_size=16,
    sb_hidden_size=20, freq_cutoffs=(0, 8, 32, 64),
    df_orders=(2, 1, 1), center_freq_sizes=(2, 8, 16),
    neighbor_freq_sizes=(3, 3, 3),
    fb_center_freq_sizes=(2, 8, 16), fb_neighbor_freq_sizes=(0, 0, 0),
    use_pre_layer_norm_fb=False, use_pre_layer_norm_sb=False,
    norm_type="cumulative_laplace_norm", bn=True, shared_weights=True)
# flagship M's structure (pre-LN on both stacks, BN, shared weights) at tiny widths
TINY_FLAGSHIP = dict(ZOO_LIKE, norm_type=None, use_pre_layer_norm_fb=True,
                     use_pre_layer_norm_sb=True, df_orders=(2, 1, 3))
CLIP = 10.0
ROWS = 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions step through time in many small ops; one thread
    each keeps them fast when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree, dtype=None):
    return jax.tree.map(lambda x: np.asarray(x, dtype), tree)


def _batch(seconds_samples, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    clean = rng.standard_normal((ROWS, seconds_samples)) * 0.1
    noisy = clean + 0.05 * rng.standard_normal((ROWS, seconds_samples))
    return noisy.astype(dtype), clean.astype(dtype)


def _jax_step(jcfg, params, state, noisy, clean):
    """The JAX stream forward's loss, new state, enhanced audio and
    gradients (the denoise recipe's loss), under jax.jit without excess
    precision (a no-op in f64)."""

    def loss_fn(p):
        out = J.spiking_fullsubnet_apply(jcfg, p, state, jnp.asarray(noisy), train=True)
        e, c = out["enhanced_y"], jnp.asarray(clean)
        loss = freq_mae(e, c) + mag_mae(e, c) + 0.001 * (100.0 - si_snr(e, c))
        return loss, (out["state"], e)

    jp = jax.tree.map(jnp.asarray, params)
    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True)).lower(jp).compile(
        compiler_options={"xla_allow_excess_precision": False})
    (loss, (new_state, enh)), g = step(jp)
    return float(loss), new_state, np.asarray(enh), g


def _port_step(pcfg, params, state, noisy, clean):
    """One port train_step: (loss, new state, enhanced audio of the same
    forward, the clipped gradient leaves, the global norm before the clip,
    the parameters after the step)."""
    tp = params_from_numpy(params, "cpu")
    leaves = jax.tree.leaves(tp)
    seen = {}
    real_apply = P.spiking_fullsubnet_apply

    def apply(*a, **kw):
        out = real_apply(*a, **kw)
        seen["enh"] = out["enhanced_y"].detach().numpy()
        return out

    losses, new_state, norm = train_step(apply, pcfg, tp, params_from_numpy(state, "cpu"),
                                         torch.from_numpy(noisy), torch.from_numpy(clean),
                                         adamw(leaves))
    return (losses["loss"].item(), new_state, seen["enh"], [t.grad.numpy() for t in leaves],
            norm.item(), leaves)


def _check_step(jcfg, pcfg, params, state, noisy, clean):
    """The port's stream step against the JAX stream forward's at the
    JAX test's tolerances; returns the global gradient norm."""
    ref_loss, ref_state, ref_enh, ref_g = _jax_step(jcfg, params, state, noisy, clean)
    loss, new_state, enh, grads, norm, leaves = _port_step(pcfg, params, state, noisy, clean)
    assert abs(loss - ref_loss) < 1e-6, (loss, ref_loss)
    np.testing.assert_allclose(enh, ref_enh, atol=3e-6)
    ref_norm = float(optax.global_norm(ref_g))
    np.testing.assert_allclose(norm, ref_norm, rtol=1e-9)
    assert jax.tree.structure(_np(ref_state)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), new_state))
    for a, r in zip(jax.tree.leaves(new_state), jax.tree.leaves(ref_state)):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-9, rtol=0)
    # torch's clip scales by CLIP / (norm + 1e-6), as on both sides here
    coef = min(1.0, CLIP / (ref_norm + 1e-6))
    for (path, r), g in zip(jax.tree_util.tree_leaves_with_path(ref_g), grads):
        np.testing.assert_allclose(g, coef * np.asarray(r), atol=1e-6, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    moved = max(float(np.abs(a.detach().numpy() - p0).max())
                for a, p0 in zip(leaves, jax.tree.leaves(params)))
    assert moved > 5e-4  # AdamW moved the weights by about lr
    return ref_norm


def _stream_cfgs(jcfg):
    kw = {k: v for k, v in jcfg.__dict__.items()
          if k not in ("scan_mode", "collect_layer_outputs")}
    return (J.SpikingFullSubNetConfig(**kw, scan_mode="stream", collect_layer_outputs=False),
            P.SpikingFullSubNetConfig(**kw, scan_mode="stream", collect_layer_outputs=False))


def test_flagship_m_stream_train_step_matches_jax_f64():
    """bench.py's training configuration at full width (random weights),
    8 x 0.25 s: the stream-train path the card takes with scan_mode="auto"."""
    b = jax_flagship_m(scan_mode="stream", collect_layer_outputs=False)
    jcfg, pcfg = _stream_cfgs(b["config"])
    noisy, clean = _batch(4000, seed=5)
    _check_step(jcfg, pcfg, _np(b["params"], np.float64), _np(b["state"], np.float64), noisy,
                clean)


def test_zoo_m_stream_train_step_matches_jax_f64():
    jcfg, pcfg = _stream_cfgs(J.separator_config(**ZOO_KW))
    tpl = J.spiking_fullsubnet_init(jax.random.PRNGKey(0), jcfg)
    tree = jax_load_npz(str(ZOO_M), {"params": tpl[0], "state": tpl[1]})
    noisy, clean = _batch(4000, seed=6)
    _check_step(jcfg, pcfg, _np(tree["params"], np.float64), _np(tree["state"], np.float64),
                noisy, clean)


def _tiny(kw, seed=0):
    jcfg, pcfg = _stream_cfgs(J.SpikingFullSubNetConfig(**kw))
    params, state = J.spiking_fullsubnet_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(7)
    for p in [params["fb"]] + params["sb"]:  # the pre-LN affine matters
        if "pre_ln" in p:
            w = p["pre_ln"]["weight"]
            p["pre_ln"]["weight"] = jnp.asarray(1 + 0.2 * rng.standard_normal(w.shape))
            p["pre_ln"]["bias"] = jnp.asarray(0.2 * rng.standard_normal(w.shape))
    return jcfg, pcfg, params, state


def test_zoo_like_cumulative_norm_stream_train_step_matches_jax_f64():
    jcfg, pcfg, params, state = _tiny(ZOO_LIKE)
    noisy, clean = _batch(4000, seed=8)
    _check_step(jcfg, pcfg, _np(params, np.float64), _np(state, np.float64), noisy, clean)


@pytest.mark.parametrize("kw", [TINY_FLAGSHIP, ZOO_LIKE, dict(ZOO_LIKE, norm_type=None),
                                dict(ZOO_LIKE, norm_type="offline_laplace_norm",
                                     shared_weights=False)],
                         ids=["pre_ln", "cum", "raw", "off_unshared"])
def test_stream_train_matches_layered_in_port_f64(kw):
    """The port's two training paths from the same weights: same loss, new
    state and gradients (the JAX test's tolerances, tests/test_stream_forward.py:129-137)."""
    _, pcfg, params, state = _tiny(kw, seed=3)
    noisy, clean = _batch(3000, seed=9)
    outs = []
    for mode in ("layered", "stream"):
        cfg = replace(pcfg, scan_mode=mode, collect_layer_outputs=mode == "layered")
        tp = params_from_numpy(_np(params, np.float64), "cpu")
        for t in jax.tree.leaves(tp):
            t.requires_grad_(True)
        out = P.spiking_fullsubnet_apply(cfg, tp, params_from_numpy(_np(state, np.float64), "cpu"),
                                         torch.from_numpy(noisy), train=True)
        loss = (out["enhanced_y"] - torch.from_numpy(clean)).abs().mean()
        loss.backward()
        outs.append((loss.item(), out["state"], [t.grad.numpy() for t in jax.tree.leaves(tp)]))
    (l1, s1, g1), (l2, s2, g2) = outs
    assert abs(l1 - l2) < 1e-6
    for a, b in zip(jax.tree.leaves(s1), jax.tree.leaves(s2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-9, rtol=0)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert max(np.abs(g).max() for g in g2) > 1e-3


def test_tiny_flagship_bf16_stream_step_close_to_jax_interpret(monkeypatch):
    """The bf16 policy: the port's bf16 streams through the plain versions
    of D and E against the JAX stream step on gsu_layer_pallas_train_padded
    with bf16 streams, in interpret mode (tests/test_stream_forward.py:144-179's
    bounds: in bf16 and f32 any two implementations part at near-threshold
    spikes, so the global gradient energy is held, not each leaf)."""
    monkeypatch.setattr(gp, "_INTERPRET", True)
    monkeypatch.setattr(JSP, "DFT_MODE", "matmul")
    kw = dict(TINY_FLAGSHIP, compute_dtype="bfloat16")
    jcfg, pcfg, params, state = _tiny(kw)
    noisy, clean = _batch(3000, seed=10, dtype=np.float32)
    calls = []
    real = gp.gsu_layer_pallas_train_padded
    monkeypatch.setattr(gp, "gsu_layer_pallas_train_padded",
                        lambda xg, *a, **k: calls.append(xg.dtype) or real(xg, *a, **k))
    ref_loss, _, _, ref_g = _jax_step(jcfg, params, state, noisy, clean)
    assert calls and all(d == jnp.bfloat16 for d in calls)  # the bf16-stream kernels ran
    loss, new_state, enh, grads, _, _ = _port_step(pcfg, _np(params), _np(state), noisy, clean)
    assert enh.dtype == np.float32 and np.isfinite(enh).all()
    assert abs(loss - ref_loss) < 2e-4 * max(abs(ref_loss), 1.0), (loss, ref_loss)
    v1 = np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in jax.tree.leaves(ref_g)])
    coef = min(1.0, CLIP / (float(np.linalg.norm(v1)) + 1e-6))
    v2 = np.concatenate([np.ravel(g) for g in grads]) / coef
    rel = float(np.linalg.norm(v1 - v2) / np.linalg.norm(v1))
    assert rel < 0.25, rel


def test_stream_train_on_a_cpu_tensor_runs_the_plain_kernels(monkeypatch):
    """"stream" with train=True on a CPU tensor runs the plain versions of
    D and E: one each per GSU layer (4 stacks x 2 layers), bf16 streams
    under the bf16 policy; with collect_layer_outputs=True the same step
    also returns the synops lists, of the JAX stream forward's shapes and,
    in f64 on the same config and weights, its values (atol 1e-9)."""
    jcfg, pcfg, params, state = _tiny(dict(TINY_FLAGSHIP, compute_dtype="bfloat16"))
    seen = {"fwd": [], "bwd": []}
    for key, name in (("fwd", "layer_train_fwd_plain"), ("bwd", "layer_train_bwd_plain")):
        real = getattr(gk, name)
        monkeypatch.setattr(gk, name, lambda xg, *a, _r=real, _k=key: seen[_k].append(xg.dtype)
                            or _r(xg, *a))
    tp = params_from_numpy(_np(params), "cpu")
    for t in jax.tree.leaves(tp):
        t.requires_grad_(True)
    noisy, _ = _batch(2000, seed=11, dtype=np.float32)
    out = P.spiking_fullsubnet_apply(pcfg, tp, params_from_numpy(_np(state), "cpu"),
                                     torch.from_numpy(noisy), train=True)
    out["enhanced_y"].abs().mean().backward()
    assert seen == {"fwd": [torch.bfloat16] * 8, "bwd": [torch.bfloat16] * 8}
    assert out["enhanced_y"].dtype == torch.float32 and out["enhanced_mag"] is not None
    assert all(t.grad is not None for t in jax.tree.leaves(tp))

    seen.update(fwd=[], bwd=[])
    coll = P.spiking_fullsubnet_apply(replace(pcfg, collect_layer_outputs=True), tp,
                                      params_from_numpy(_np(state), "cpu"),
                                      torch.from_numpy(noisy), train=True)
    assert seen["fwd"] == [torch.bfloat16] * 8
    assert torch.equal(coll["enhanced_y"], out["enhanced_y"])
    f64 = lambda t: _np(t, np.float64)  # noqa: E731
    jc = replace(jcfg, compute_dtype=None, collect_layer_outputs=True)
    ref = J.spiking_fullsubnet_apply(jc, f64(params), f64(state), jnp.asarray(noisy, jnp.float64),
                                     train=True)
    got = P.spiking_fullsubnet_apply(
        replace(pcfg, compute_dtype=None, collect_layer_outputs=True),
        params_from_numpy(f64(params), "cpu"), params_from_numpy(f64(state), "cpu"),
        torch.from_numpy(noisy.astype(np.float64)), train=True)
    for key in ("fb_all_layer_outputs", "sb_all_layer_outputs"):
        r_leaves = jax.tree.leaves(ref[key])
        assert len(jax.tree.leaves(coll[key])) == len(jax.tree.leaves(got[key])) == len(r_leaves)
        for c, g, r in zip(jax.tree.leaves(coll[key]), jax.tree.leaves(got[key]), r_leaves):
            assert tuple(c.shape) == tuple(g.shape) == tuple(r.shape)
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(r), atol=1e-9, rtol=0)
