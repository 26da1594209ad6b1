"""The port's per-module activation tracer (nn/module_tracer.py) and its
hooks against the JAX package's, on the tiny model of
tests/test_debug_tracer.py in float64.

- eval and training: the frames' names, in order, equal the JAX tracer's on
  the same weights (carried across with ``params_from_numpy``) and input;
  their finite flags are equal and their extremes within 1e-9 (the spikes'
  exactly); the GSU layers' membrane frames come from kernel F's plain
  version in eval and kernel D's in training;
- the abort: +inf in fullband layer 1's ``weight_hh`` raises
  ``FloatingPointAbort`` whose first line names ``fb/gsu_layer1/membrane``
  and whose trail holds the JAX trail's names;
- with no tracer open a hook builds no tensor operation and the forward is
  bit for bit the one with a tracer open; contexts do not nest;
- the kernel trace's NaN handling: extremes that skip NaN plus the counts
  give the frame that the whole tensor gives;
- a route that calls no hook (here the serving forward) is named in
  ``untraced_routes`` and ``report()`` and warned of once, so that its
  empty trace is not read as a clean run.
"""

from __future__ import annotations

import logging
import math
from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.models import spiking_fullsubnet as JSF
from spiking_fullsubnet_tpu.runtime.debug import ActivationTracer as JTracer

from spiking_fullsubnet_torch.models import spiking_fullsubnet as PSF
from spiking_fullsubnet_torch.nn import module_tracer as MT
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy
from spiking_fullsubnet_torch.runtime.debug import ActivationTracer, FloatingPointAbort

TINY = dict(fb_input_size=16, fb_hidden_size=24, fb_num_layers=2, fb_proj_size=16,
            sb_hidden_size=16, sb_num_layers=2, freq_cutoffs=[0, 8, 32], df_orders=[2, 1],
            center_freq_sizes=[2, 8], neighbor_freq_sizes=[3, 3], n_fft=64, hop_length=16,
            win_length=64, bn=True, shared_weights=True)


def _f64(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float64), tree)


@pytest.fixture(scope="module")
def models():
    jb = JSF.build(seed=0, **TINY)
    pb = PSF.build(seed=0, device="cpu", **TINY)
    params, state = _f64(jb["params"]), _f64(jb["state"])
    noisy = np.random.default_rng(0).standard_normal((2, 1600))
    return dict(jcfg=jb["config"], pcfg=pb["config"], params=params, state=state, noisy=noisy)


def _jax_frames(m, params, train):
    with JTracer() as tr:
        JSF.spiking_fullsubnet_apply(m["jcfg"], jax.tree.map(jnp.asarray, params),
                                     jax.tree.map(jnp.asarray, m["state"]),
                                     jnp.asarray(m["noisy"]), train=train)
    return tr.frames


def _port(m, params, train):
    with ActivationTracer() as tr:
        out = PSF.spiking_fullsubnet_apply(m["pcfg"], params_from_numpy(params, "cpu"),
                                           params_from_numpy(m["state"], "cpu"),
                                           torch.from_numpy(m["noisy"]), train=train)
    return tr, out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_frames_equal_jax(models, train):
    ref = _jax_frames(models, models["params"], train)
    tr, _ = _port(models, models["params"], train)
    assert [f[0] for f in tr.frames] == [f[0] for f in ref]
    names = [f[0] for f in tr.frames]
    assert names[:7] == ["fb/pre_ln", "fb/gsu_layer0/membrane", "fb/gsu_layer0/spikes",
                         "fb/gsu_layer1/membrane", "fb/gsu_layer1/spikes", "fb/proj",
                         "sb0/pre_ln"]
    assert any(n.startswith("sb1/gsu_layer1/") for n in names)
    for (name, mn, mx, ok), (_, rmn, rmx, rok) in zip(tr.frames, ref):
        assert ok == rok and ok, name
        tol = 0.0 if name.endswith("spikes") else 1e-9
        np.testing.assert_allclose([mn, mx], [rmn, rmx], rtol=tol, atol=tol, err_msg=name)
    assert "fb/pre_ln" in tr.report()
    assert tr.untraced_routes == [] and "no frames from" not in tr.report()


def test_routes_without_hooks_are_named(models, caplog):
    cfg = replace(models["pcfg"], scan_mode="stream", collect_layer_outputs=False)
    args = (params_from_numpy(models["params"], "cpu"), params_from_numpy(models["state"], "cpu"),
            torch.from_numpy(models["noisy"]))
    with caplog.at_level(logging.WARNING, logger=MT.__name__):
        with ActivationTracer() as tr:
            for _ in range(2):
                PSF.spiking_fullsubnet_apply(cfg, *args)
        PSF.spiking_fullsubnet_apply(cfg, *args)  # no tracer open: nothing noted
    assert tr.frames == [] and tr.untraced_routes == ["serving forward"]
    assert tr.report() == "  (no frames from the serving forward)"
    assert [r.getMessage() for r in caplog.records] == [
        'activation tracer: the serving forward records no frames; use scan_mode="layered" '
        'for per-module frames']


def test_abort_names_the_layer(models):
    params = jax.tree.map(np.copy, models["params"])
    params["fb"]["stack"]["layers"][1]["weight_hh"][0, 0] = np.inf
    with pytest.raises(Exception) as jexc:
        _jax_frames(models, params, False)
    with pytest.raises(FloatingPointAbort) as exc:
        _port(models, params, False)
    msg = str(exc.value)
    assert "fb/gsu_layer1/membrane" in msg.splitlines()[0], msg
    assert "module trail" in msg
    jtrail = [line.split()[-3] if line.lstrip().startswith("!!") else line.split()[0]
              for line in str(jexc.value).split("most recent last):\n")[1].splitlines()]
    trail = [line.split()[-3] if line.lstrip().startswith("!!") else line.split()[0]
             for line in msg.split("most recent last):\n")[1].splitlines()]
    assert trail == jtrail == ["fb/pre_ln", "fb/gsu_layer0/membrane", "fb/gsu_layer0/spikes",
                               "fb/gsu_layer1/membrane"]
    assert MT._ACTIVE is None  # the context closed on the way out


def test_no_tracer_no_work_and_same_output(models, monkeypatch):
    _, traced = _port(models, models["params"], False)

    def boom(*a, **k):
        raise AssertionError("a hook did work with no tracer open")

    monkeypatch.setattr(MT, "abs_extremes", boom)
    monkeypatch.setattr(gk, "trace_fold", boom)
    out = PSF.spiking_fullsubnet_apply(models["pcfg"], params_from_numpy(models["params"], "cpu"),
                                       params_from_numpy(models["state"], "cpu"),
                                       torch.from_numpy(models["noisy"]))
    assert torch.equal(out["enhanced_y"], traced["enhanced_y"])
    for a, b in zip(out["fb_all_layer_outputs"], traced["fb_all_layer_outputs"]):
        assert torch.equal(a, b)
    with ActivationTracer():
        with pytest.raises(RuntimeError, match="do not nest"):
            ActivationTracer().__enter__()
    assert not MT.tracing_active()


def test_trace_scopes_and_identity():
    x = torch.tensor([-3.0, 0.5, 2.0])
    assert MT.trace_activation("x", x) is x
    with ActivationTracer(abort_on_nonfinite=False) as tr:
        with MT.module_scope("a"):
            with MT.module_scope("b"):
                assert MT.trace_activation("x", x) is x
            MT.trace_activation("y", torch.tensor([1.0, math.inf]))
    assert tr.frames == [("a/b/x", 0.5, 3.0, True), ("a/y", 1.0, math.inf, False)]
    assert "!! a/y" in tr.report()


@pytest.mark.parametrize("poison", ["none", "inf", "nan", "both"])
def test_kernel_trace_frame_equals_tensor_frame(poison):
    c = torch.randn(2, 5, 7, dtype=torch.float64)
    if poison in ("inf", "both"):
        c[0, 1, 2] = -math.inf
    if poison in ("nan", "both"):
        c[1, 3, 4] = math.nan
    ext = gk.trace_init(2, "cpu")
    for t in range(c.shape[1]):  # step by step, as the plain version folds
        gk.trace_fold(ext, c[:, t])
    for k in range(2):
        got, ref = MT.extremes_frame(ext[k]), MT.abs_extremes(c[k])
        assert got[2] == ref[2]
        np.testing.assert_array_equal(got[:2], ref[:2])


def test_plain_f_trace_matches_its_membranes():
    """The plain version's trace equals the extremes of the membranes that
    the stack's own steps (``_stack_layers_step``, BN folded) give."""
    from spiking_fullsubnet_torch.ops.gsu import gsu_cell_init

    gen = torch.Generator().manual_seed(3)
    layers, states = [], []
    for i in range(2):
        p, s = gsu_cell_init(gen, 6 if i == 0 else 8, 8, shared_weights=False, bn=True)
        s["bn"]["running_var"] = torch.rand(8, generator=gen) + 0.5
        layers.append(p)
        states.append(s)
    x = torch.randn(9, 3, 6, dtype=torch.float64, generator=gen)
    packed = gk.pack_stack_x(layers, states, 8, torch.float64)
    spikes, ext = gk.gsu_stack_eval_x(x, *packed, 8, False, trace=True)
    assert torch.equal(spikes, gk.gsu_stack_eval_x(x, *packed, 8, False))
    wih0, wihr, whh, coef = (t.double() for t in packed)
    h = [torch.zeros(3, 8, dtype=torch.float64) for _ in range(2)]
    c = [torch.zeros(3, 8, dtype=torch.float64) for _ in range(2)]
    mem = [[], []]
    for t in range(9):
        gk._stack_layers_step(x[t] @ wih0, h, c, wihr, whh, coef, 8, False)
        for k in range(2):
            mem[k].append(c[k])
    for k in range(2):
        m = torch.stack(mem[k])
        assert ext[k].tolist() == [m.abs().min().item(), m.abs().max().item(), 0.0, 0.0]
