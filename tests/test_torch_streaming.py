"""The port's hop-synchronous streaming (``spiking_fullsubnet_torch/
streaming.py``) against the JAX package's ``StreamingEnhancer`` and against
the port's own offline forward, on the CPU at the JAX tests' tiny sizes.

The same weights (``spiking_fullsubnet_init`` of the JAX package, carried
across with ``params_from_numpy``) and the same float32 audio go through
both steppers hop by hop. Bounds: the audio within 2e-4 (the JAX tests'
bound between the streamed and offline formulations) and every layer's
spikes equal at every step; the port's stream against its offline forward
in the interior within 2e-4 (``tests/test_streaming.py:55-56``); chunk
sizes within 1e-5 (``tests/test_streaming.py:71``).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.models.spiking_fullsubnet import (
    SpikingFullSubNetConfig as JaxConfig, spiking_fullsubnet_init)
from spiking_fullsubnet_tpu.streaming import StreamingEnhancer as JaxStreamingEnhancer

from spiking_fullsubnet_torch.models.spiking_fullsubnet import (SpikingFullSubNetConfig,
                                                                 spiking_fullsubnet_apply)
from spiking_fullsubnet_torch.runtime.convert import params_from_numpy
from spiking_fullsubnet_torch.streaming import StreamingEnhancer, state_leaves

TINY = dict(fb_hidden_size=32, sb_hidden_size=16, df_orders=(3, 2, 1), bn=True,
            shared_weights=True)
CUM = dict(norm_type="cumulative_laplace_norm", use_pre_layer_norm_fb=False,
           use_pre_layer_norm_sb=False)


def _weights(seed, **kw):
    """(port config, JAX config, JAX params, JAX state, port params, port state)."""
    jcfg = JaxConfig(**TINY, **kw)
    params, state = spiking_fullsubnet_init(jax.random.PRNGKey(seed), jcfg)
    to_port = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), device="cpu")  # noqa: E731
    return (SpikingFullSubNetConfig(**TINY, **kw), jcfg, params, state, to_port(params),
            to_port(state))


def _audio(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


def _layer_spikes(state):
    """Every layer's spikes of the last frame: fullband layers, then each
    section's ([h, c] in the port, (h, c) in JAX)."""
    return [layer[0] for layer in state["fb"]] + [layer[0] for sec in state["sb"] for layer in sec]


@pytest.mark.parametrize("chunk_frames, batch, primed, norm", [
    (1, 1, True, False),
    (4, 1, False, False),
    (1, 2, True, True),
    (4, 2, False, True),
], ids=["hop-primed", "chunk4", "cum-batch2-primed", "cum-chunk4-batch2"])
def test_stream_matches_jax_stream(chunk_frames, batch, primed, norm):
    cfg, jcfg, jp, js, params, state = _weights(3, **(CUM if norm else {}))
    x = _audio((batch, 6000), 7)
    port = StreamingEnhancer(cfg, params, state, batch_size=batch, chunk_frames=chunk_frames,
                             device="cpu")
    ref = JaxStreamingEnhancer(jcfg, jp, js, batch_size=batch, chunk_frames=chunk_frames)
    prime = x[:, :port.prime_len] if primed else None
    st, jst = port.init_state(prime_samples=prime), ref.init_state(prime_samples=prime)
    stream = x[:, port.prime_len:] if primed else x
    chunk = chunk_frames * cfg.hop_length
    for i in range(0, stream.shape[-1] - chunk + 1, chunk):
        c = stream[:, i:i + chunk]
        st, y = port.step(st, torch.from_numpy(c))
        jst, jy = ref.step(jst, jnp.asarray(c))
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-4, rtol=0)
        for k, (a, b) in enumerate(zip(_layer_spikes(st), _layer_spikes(jst))):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"step {i}, layer {k}")
    # the rest of the state: the same leaves, the deep-filter taps as (re, im) pairs
    np.testing.assert_allclose(st["ola_tail"].numpy(), np.asarray(jst["ola_tail"]), atol=2e-4)
    np.testing.assert_array_equal(st["in_buffer"].numpy(), np.asarray(jst["in_buffer"]))
    for a, b in zip(st["df_taps"], jst["df_taps"]):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), np.stack([b.real, b.imag], -1), atol=1e-5)
    np.testing.assert_allclose(st["norm_sum"].numpy(), np.asarray(jst["norm_sum"]), rtol=1e-5)
    assert float(st["norm_count"]) == float(jst["norm_count"])


def _primed_interior(cfg, params, state, x):
    """(the primed stream's interior, the offline forward's), aligned as
    ``tests/test_streaming.py:43-56``."""
    hop, pad = cfg.hop_length, cfg.n_fft // 2
    enh = StreamingEnhancer(cfg, params, state, device="cpu")
    st, outs = enh.init_state(prime_samples=x[:, :enh.prime_len]), []
    rest = torch.from_numpy(x[:, enh.prime_len:])
    for i in range(0, rest.shape[-1] - hop + 1, hop):
        st, y = enh.step(st, rest[:, i:i + hop])
        outs.append(y)
    out = torch.cat(outs, dim=-1).numpy()
    offline = spiking_fullsubnet_apply(cfg, params, state, torch.from_numpy(x))["enhanced_y"]
    aligned = out[:, (pad // hop + 1) * hop:]
    n = aligned.shape[-1] - 2 * hop
    return aligned[:, :n], offline.numpy()[:, hop:hop + n]


@pytest.mark.parametrize("norm", [False, True], ids=["pre-ln", "cumulative"])
def test_stream_interior_matches_offline_forward(norm):
    cfg, _, _, _, params, state = _weights(0, **(CUM if norm else {}))
    got, want = _primed_interior(cfg, params, state, _audio((1, 8000), 1))
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_chunk_size_invariance():
    cfg, _, _, _, params, state = _weights(1)
    x = _audio((2, 4096), 2)
    y1 = StreamingEnhancer(cfg, params, state, batch_size=2, chunk_frames=1,
                           device="cpu").enhance_stream(x)
    y4 = StreamingEnhancer(cfg, params, state, batch_size=2, chunk_frames=4,
                           device="cpu").enhance_stream(x)
    np.testing.assert_allclose(y1, y4, atol=1e-5, rtol=0)
    assert y1.shape == x.shape
    odd = StreamingEnhancer(cfg, params, state, batch_size=2, chunk_frames=4, device="cpu")
    assert odd.enhance_stream(x[:, :3001]).shape == (2, 3001)  # padded to whole chunks


def test_step_leaves_the_given_state_untouched():
    cfg, _, _, _, params, state = _weights(2)
    enh = StreamingEnhancer(cfg, params, state, device="cpu")
    st = enh.init_state()
    chunk = torch.from_numpy(_audio((1, cfg.hop_length), 4))
    st1, y1 = enh.step(st, chunk)
    kept = [t.clone() for t in state_leaves(st1)]
    st2, _ = enh.step(st1, chunk)
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(st1), kept))
    assert not torch.equal(st2["ola_tail"], st1["ola_tail"])
    _, y1_again = enh.step(st, chunk)
    assert torch.equal(y1, y1_again)
    with pytest.raises(ValueError, match="chunk shape"):
        enh.step(st, chunk[:, :-1])
    with pytest.raises(ValueError, match="prime_samples"):
        enh.init_state(prime_samples=np.zeros((1, enh.prime_len + 1), np.float32))


def test_streaming_refuses_what_cannot_stream_as_jax_does():
    cfg, _, _, _, params, state = _weights(0)
    for change, match in ((dict(norm_type="offline_laplace_norm"), "Non-causal norm"),
                          (dict(num_spks=2), "single-speaker")):
        with pytest.raises(NotImplementedError, match=match):
            StreamingEnhancer(replace(cfg, **change), params, state, device="cpu")
        with pytest.raises(NotImplementedError, match=match):
            JaxStreamingEnhancer(replace(JaxConfig(**TINY), **change), params, state)


def test_streaming_wants_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    cfg, _, _, _, params, state = _weights(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingEnhancer(cfg, params, state)
