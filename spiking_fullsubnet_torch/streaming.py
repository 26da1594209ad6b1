"""Hop-synchronous streaming enhancement (counterpart of
``spiking_fullsubnet_tpu/streaming.py``).

The challenge's latency accounting (one 128-sample hop at 16 kHz, 8 ms)
presumes that audio is enhanced hop by hop. ``StreamingEnhancer`` holds the
weights and steps a state through chunks of ``chunk_frames`` hops: each
frame takes ``hop`` new samples and gives ``hop`` enhanced ones. The state
is a dict of float32 tensors:

- ``in_buffer [B, n_fft - hop]``: the last input samples (the analysis
  buffer); ``ola_tail [B, n_fft - hop]``: the overlap-add tail;
- ``fb``: per fullband layer ``[h, c]`` ``[B, H]``; ``sb``: per section, per
  layer ``[h, c]`` ``[B n, H]``, the section's n units folded into rows
  (lists, so that the nesting is that of the ``/``-joined paths an ``.npz``
  of the state holds: ``runtime/convert.load_npz`` rebuilds it);
- ``df_taps``: per section the deep filter's ``df - 1`` past frames of the
  section's spectrum ``[B, 1, F_i, df - 1, 2]``, real and imaginary parts
  on the last axis (the JAX package keeps them complex; real pairs let the
  state be one type, which the CUDA graph's buffers and ``torch.export``
  take);
- ``norm_sum [B]``, ``sb_norm_sums`` per section ``[B n]`` and
  ``norm_count []``: the cumulative laplace norm's running sums, one for
  the fullband input and one per section's units, and the frame count.

Each frame follows the JAX step (``_frame_step``): the windowed ``rfft`` of
the buffer, ``|X|^fdrc`` without the Nyquist bin, one step of the fullband
sequence model (pre-LN, each GSU cell with BN folded to an affine at eps
1e-5, the projection and its activation), per section the unfold of the
magnitude and of the tiled fullband output, the causal norm, the section's
sequence model and its deep-filter coefficients over the tap history, the
Nyquist passthrough, one ``irfft`` frame, the overlap-add and the division
by the steady-state COLA envelope. ``eager_step`` is that chunk step in
plain PyTorch operations (float32); it runs on a CPU tensor as written, and
it is what ``tools/export_serving`` exports.

On the card ``step`` replays a ``torch.cuda.CUDAGraph`` of ``eager_step``,
captured at the first step with the chunk's frames unrolled inside it (the
eager step is some two hundred small launches a hop, which at batch 1 the
host cannot issue as fast as the card runs them). The graph reads a static
copy of the state and the chunk and writes the new state and the enhanced
samples into one static flat buffer. ``step`` copies the state it is given
into the static inputs (one multi-tensor copy), replays the graph and
returns a clone of the output buffer as the new state's leaves and the
enhanced samples: the state given is never written, and a state returned
earlier stays valid. The capture warms up on a side stream first, so that
cuFFT's plans exist before it starts; a failed capture raises.

As in the JAX package, streaming takes ``num_spks == 1`` and a causal norm
(none or ``cumulative_laplace_norm``) only. The streamed output equals the
offline forward in the interior once the stream is primed
(``init_state(prime_samples=...)``); the first and last ``n_fft // 2``
samples differ by the offline graph's centre padding.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .dsp.spectral import hann_window
from .nn.core import layer_norm_apply, linear_apply, output_activation
from .ops.freq_unfold import reflect_unfold_indices
from .ops.gsu import bn_eval_affine, spike
from .runtime.device import resolve_device

EPS = 2.220446049250313e-16  # the cumulative norm's epsilon (float64 machine epsilon)


def state_leaves(state) -> List[torch.Tensor]:
    """The leaves of a state (dicts in key order, lists and tuples in
    order), the order in which ``rebuild_state`` takes them."""
    if isinstance(state, dict):
        return [t for v in state.values() for t in state_leaves(v)]
    if isinstance(state, (list, tuple)):
        return [t for v in state for t in state_leaves(v)]
    return [state]


def state_paths(state, prefix: str = "") -> List[str]:
    """``/``-joined paths of the leaves, in ``state_leaves`` order."""
    if isinstance(state, dict):
        return [p for k, v in state.items() for p in state_paths(v, f"{prefix}{k}/")]
    if isinstance(state, (list, tuple)):
        return [p for i, v in enumerate(state) for p in state_paths(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


def rebuild_state(template, leaves):
    """A state of ``template``'s nesting with ``leaves`` (an iterator or a
    list, in ``state_leaves`` order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(build(v) for v in node)
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)

    return build(template)


def _layer_weights(params, state, acc: torch.dtype):
    """One sequence model's step weights: per layer (W_ih^T, W_hh^T, b_f,
    b_c, BN scale, BN shift) with BN as the JAX ``_bn_affines`` folds it
    (``rsqrt(var + 1e-5)``), or None for the scale and shift without BN.
    Each its own contiguous tensor (not a view), which an exported step
    holds as one constant."""
    layers = []
    for lp, ls in zip(params["stack"]["layers"], state["stack"]["layers"]):
        H = lp["weight_hh"].shape[1]
        affine = bn_eval_affine(lp, ls, acc) if "bn" in lp else (None, None)
        own = (lp["weight_ih"].T, lp["weight_hh"].T, lp["bias_ih"][:H], lp["bias_ih"][H:])
        layers.append(tuple(t.to(acc).clone(memory_format=torch.contiguous_format) for t in own)
                      + affine)
    return layers


def _seq_model_step(seq_cfg, params, layers, x_t: torch.Tensor, states):
    """One timestep of a sequence model (``streaming.py:51-85``): pre-LN,
    the GSU cells, the projection and its activation. ``x_t [R, in]``,
    ``states`` per layer ``[h, c]``; returns (out ``[R, P]``, new states)."""
    if seq_cfg.use_pre_layer_norm:
        x_t = layer_norm_apply(params["pre_ln"], x_t)
    out, new_states, H = x_t, [], seq_cfg.hidden_size
    for (w_ih, w_hh, b_f, b_c, scale, shift), (h, c) in zip(layers, states):
        xg = out @ w_ih
        rg = h @ w_hh
        if seq_cfg.shared_weights:
            f_in = xg + rg + b_f
            c_in = xg + rg + b_c
        else:
            f_in = xg[:, :H] + rg[:, :H] + b_f
            c_in = xg[:, H:] + rg[:, H:] + b_c
        f = torch.sigmoid(f_in)
        cy = f * c + (1.0 - f) * c_in
        if scale is not None:
            cy = cy * scale + shift
        out = spike(cy)
        new_states.append([out, cy])
    if seq_cfg.proj_size > 0:
        out = linear_apply(params["proj"], out)
    return output_activation(seq_cfg.output_activate_function)(out), new_states


class StreamingEnhancer:
    """Hop-synchronous streaming around Spiking-FullSubNet weights (the
    port's ``params``/``state`` trees, as ``spiking_fullsubnet_init`` or
    ``load_npz`` give them) on ``device`` (default ``cuda``).

    Limitations, as in the JAX package: ``num_spks == 1``; ``norm_type``
    None or ``cumulative_laplace_norm`` (the offline norms cannot stream)."""

    def __init__(self, cfg, params, model_state, batch_size: int = 1, chunk_frames: int = 1,
                 device=None):
        if cfg.num_spks != 1:
            raise NotImplementedError("Streaming supports single-speaker enhancement.")
        if cfg.norm_type not in (None, "cumulative_laplace_norm"):
            raise NotImplementedError(f"Non-causal norm {cfg.norm_type} cannot stream.")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.chunk_frames = chunk_frames
        f32, dev = torch.float32, self.device
        to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) else (  # noqa: E731
            [to(v) for v in t] if isinstance(t, list) else t.detach().to(dev, f32))
        self.params, self.model_state = to(params), to(model_state)
        self.window = hann_window(cfg.win_length, device=dev)
        # steady-state OLA normalizer for one hop (COLA sum of squared windows)
        r, hop = cfg.n_fft // cfg.hop_length, cfg.hop_length
        wsq = self.window.cpu().numpy() ** 2
        env = np.zeros(hop)
        for k in range(r):
            env += wsq[k * hop:(k + 1) * hop]
        self._ola_env = torch.as_tensor(env, dtype=f32, device=dev)
        self._fb_layers = _layer_weights(self.params["fb"], self.model_state["fb"], f32)
        self._sb_layers = [_layer_weights(self.params["sb"][i], self.model_state["sb"][i], f32)
                           for i in range(cfg.num_sections)]
        # per section: gather indices of its units' input lanes in [mag (F) | fb_out (P)]
        P, F = cfg.fb_proj_size, cfg.num_freqs
        width = (cfg.n_fft // 2 + 1) // cfg.fb_input_size * P  # the tiled fullband output
        self._sb_index = []
        for i in range(cfg.num_sections):
            lo, hi = cfg.freq_cutoffs[i], cfg.freq_cutoffs[i + 1]
            idx_n = reflect_unfold_indices(lo, hi, cfg.center_freq_sizes[i],
                                           cfg.neighbor_freq_sizes[i], F)
            idx_f = reflect_unfold_indices(lo, hi, cfg.fb_ctrs[i], cfg.fb_nbrs[i], width) % P
            self._sb_index.append(torch.as_tensor(np.concatenate([idx_n, F + idx_f], axis=1),
                                                  device=dev))
        self._graph: Optional[Dict[str, Any]] = None

    # ------------------------------------------------------------- state

    @property
    def prime_len(self) -> int:
        """Number of leading input samples ``init_state(prime_samples=...)``
        takes to make the streamed frames coincide with the offline centred
        STFT: buf_len - n_fft // 2 = n_fft // 2 - hop."""
        return (self.cfg.n_fft - self.cfg.hop_length) - self.cfg.n_fft // 2

    def _units(self, i: int) -> int:
        cfg = self.cfg
        return (cfg.freq_cutoffs[i + 1] - cfg.freq_cutoffs[i]) // cfg.center_freq_sizes[i]

    def init_state(self, prime_samples=None) -> Dict[str, Any]:
        """Fresh stream state (``streaming.py:145-199``).

        prime_samples: optional ``[B, prime_len]`` leading input samples. The
            offline graph centre-pads n_fft // 2 zeros, so its frame 0 covers
            ``[zeros(n_fft // 2), x[:n_fft // 2]]``; pre-loading the analysis
            buffer with ``[zeros(n_fft // 2), x[:prime_len]]`` and streaming
            from ``x[prime_len:]`` reproduces the offline frames exactly."""
        cfg, b, dev = self.cfg, self.batch_size, self.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        def zeros_states(seq_cfg, rows):
            return [[zeros(rows, seq_cfg.hidden_size), zeros(rows, seq_cfg.hidden_size)]
                    for _ in range(seq_cfg.num_layers)]

        buf_len = cfg.n_fft - cfg.hop_length
        if prime_samples is not None:
            prime = torch.as_tensor(prime_samples, dtype=torch.float32, device=dev)
            if prime.shape[-1] != self.prime_len:
                raise ValueError(f"prime_samples must be [B, {self.prime_len}]")
            in_buffer = torch.cat([zeros(b, cfg.n_fft // 2), prime], dim=-1)
        else:
            in_buffer = zeros(b, buf_len)
        n_sec = range(cfg.num_sections)
        return {
            "in_buffer": in_buffer,
            "ola_tail": zeros(b, buf_len),
            "fb": zeros_states(cfg.fb_config(), b),
            "sb": [zeros_states(cfg.sb_config(i), b * self._units(i)) for i in n_sec],
            "df_taps": [zeros(b, 1, cfg.freq_cutoffs[i + 1] - cfg.freq_cutoffs[i],
                              cfg.df_orders[i] - 1, 2) for i in n_sec],
            "norm_sum": zeros(b),
            "sb_norm_sums": [zeros(b * self._units(i)) for i in n_sec],
            "norm_count": zeros(),
        }

    # ------------------------------------------------------------- core

    def _frame_step(self, state, new_samples: torch.Tensor):
        """One hop of samples -> one enhanced hop (``streaming.py:201-297``)."""
        cfg, hop = self.cfg, self.cfg.hop_length
        buf = torch.cat([state["in_buffer"], new_samples], dim=-1)  # [B, n_fft]
        spec = torch.fft.rfft(buf * self.window, n=cfg.n_fft, dim=-1)  # [B, F+1]
        mag = (spec.abs() ** cfg.fdrc)[:, :-1]  # drop Nyquist -> [B, F]

        use_cln = cfg.norm_type == "cumulative_laplace_norm"
        new_frames = state["norm_count"] + 1.0

        # fullband (one timestep); the causal norm streams per consumer:
        # the fullband input slice, then each section's unfolded features
        fb_in = mag[:, :cfg.fb_input_size]
        new_fb_sum = state["norm_sum"]
        if use_cln:
            new_fb_sum = new_fb_sum + fb_in.sum(dim=-1)
            mu = new_fb_sum / (cfg.fb_input_size * new_frames)
            fb_in = fb_in / (mu[:, None] + EPS)
        fb_out, new_fb = _seq_model_step(cfg.fb_config(), self.params["fb"], self._fb_layers,
                                         fb_in, state["fb"])
        lanes = torch.cat([mag, fb_out], dim=-1)  # [B, F + P]: the tile is fb_out mod P

        spec_ri = torch.view_as_real(spec)  # [B, F+1, 2]
        b = buf.shape[0]
        new_sb, new_sums, new_taps, enh_re, enh_im = [], [], [], [], []
        for i in range(cfg.num_sections):
            lo, hi, df = cfg.freq_cutoffs[i], cfg.freq_cutoffs[i + 1], cfg.df_orders[i]
            flat = lanes[:, self._sb_index[i]].reshape(b * self._units(i), -1)  # [B n, w]
            new_sum = state["sb_norm_sums"][i]
            if use_cln:
                new_sum = new_sum + flat.sum(dim=-1)
                mu = new_sum / (flat.shape[-1] * new_frames)
                flat = flat / (mu[:, None] + EPS)
            new_sums.append(new_sum)
            out, st = _seq_model_step(cfg.sb_config(i), self.params["sb"][i], self._sb_layers[i],
                                      flat, state["sb"][i])
            new_sb.append(st)
            # "(b n) (c fc df) -> b (n fc) df c"
            coef = out.reshape(b, self._units(i), 2, cfg.center_freq_sizes[i], df)
            coef = coef.permute(0, 1, 3, 4, 2).reshape(b, hi - lo, df, 2)
            taps = torch.cat([state["df_taps"][i], spec_ri[:, None, lo:hi, None]], dim=-2)
            tr, ti = taps[:, 0, ..., 0], taps[:, 0, ..., 1]  # [B, F_i, df]
            cr, ci = coef[..., 0], coef[..., 1]
            enh_re.append((tr * cr - ti * ci).sum(dim=-1))
            enh_im.append((tr * ci + ti * cr).sum(dim=-1))
            new_taps.append(taps[..., 1:, :])

        enh = torch.complex(torch.cat(enh_re + [spec_ri[:, -1:, 0]], dim=-1),
                            torch.cat(enh_im + [spec_ri[:, -1:, 1]], dim=-1))  # Nyquist passthrough
        frame = torch.fft.irfft(enh, n=cfg.n_fft, dim=-1) * self.window  # [B, n_fft]
        tail = state["ola_tail"]
        out_samples = (tail[:, :hop] + frame[:, :hop]) / self._ola_env
        new_tail = torch.cat([tail[:, hop:], torch.zeros_like(tail[:, :hop])], dim=-1) \
            + frame[:, hop:]
        new_state = {
            "in_buffer": buf[:, hop:],
            "ola_tail": new_tail,
            "fb": new_fb,
            "sb": new_sb,
            "df_taps": new_taps,
            "norm_sum": new_fb_sum,
            "sb_norm_sums": new_sums,
            "norm_count": new_frames,
        }
        return new_state, out_samples

    def eager_step(self, state, chunk: torch.Tensor):
        """``chunk [B, chunk_frames * hop]`` -> (new state, enhanced ``[B,
        chunk_frames * hop]``) in plain PyTorch operations, the frames in
        turn (``streaming.py:290-295``)."""
        hop, outs = self.cfg.hop_length, []
        for t in range(chunk.shape[-1] // hop):
            state, y = self._frame_step(state, chunk[:, t * hop:(t + 1) * hop])
            outs.append(y)
        new_state = rebuild_state(state, [t.contiguous() for t in state_leaves(state)])
        return new_state, torch.cat(outs, dim=-1)

    # ------------------------------------------------------------- the CUDA graph

    def _capture(self, state, chunk: torch.Tensor) -> Dict[str, Any]:
        """The chunk step as a CUDA graph over static buffers: the inputs one
        tensor a leaf (and the chunk), the outputs one flat buffer."""
        static_in = [t.detach().clone() for t in state_leaves(state)] + [chunk.clone()]
        template = state
        sizes: List[Tuple[int, ...]] = []

        def body(out: Optional[torch.Tensor]) -> torch.Tensor:
            st = rebuild_state(template, static_in[:-1])
            new_state, y = self.eager_step(st, static_in[-1])
            leaves = state_leaves(new_state) + [y]
            if not sizes:
                sizes.extend(tuple(t.shape) for t in leaves)
            flat = [t.reshape(-1) for t in leaves]
            if out is None:
                return torch.cat(flat)
            return torch.cat(flat, out=out)

        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):  # warm-up: cuFFT plans, cuBLAS handles
            static_out = body(None)
            for _ in range(2):
                body(static_out)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body(static_out)
        return {"graph": graph, "inputs": static_in, "out": static_out, "sizes": sizes,
                "template": template}

    def _graph_step(self, state, chunk: torch.Tensor):
        if self._graph is None:
            self._graph = self._capture(state, chunk)
        g = self._graph
        torch._foreach_copy_(g["inputs"], state_leaves(state) + [chunk])
        g["graph"].replay()
        flat = g["out"].clone()
        views, o = [], 0
        for shape in g["sizes"]:
            n = int(np.prod(shape))
            views.append(flat[o:o + n].view(shape))
            o += n
        return rebuild_state(g["template"], views[:-1]), views[-1]

    # ------------------------------------------------------------- API

    def step(self, state, chunk):
        """Consume ``chunk_frames * hop`` new samples ``[B, chunk_frames *
        hop]``; returns (new state, enhanced samples). On the card the CUDA
        graph of ``eager_step``, on the CPU ``eager_step`` itself."""
        chunk = torch.as_tensor(chunk, dtype=torch.float32, device=self.device)
        expect = (self.batch_size, self.chunk_frames * self.cfg.hop_length)
        if tuple(chunk.shape) != expect:
            raise ValueError(f"chunk shape {tuple(chunk.shape)}, expected {expect}")
        if self.device.type == "cuda":
            return self._graph_step(state, chunk.contiguous())
        return self.eager_step(state, chunk)

    def enhance_stream(self, audio: np.ndarray) -> np.ndarray:
        """Convenience: a whole ``[B, T]`` signal through ``step``."""
        chunk = self.chunk_frames * self.cfg.hop_length
        b, t = audio.shape
        t_pad = -(-t // chunk) * chunk
        if t_pad != t:
            audio = np.pad(audio, ((0, 0), (0, t_pad - t)))
        audio = torch.as_tensor(np.ascontiguousarray(audio), dtype=torch.float32,
                                device=self.device)
        state, outs = self.init_state(), []
        for i in range(0, t_pad, chunk):
            state, y = self.step(state, audio[:, i:i + chunk])
            outs.append(y)
        return torch.cat(outs, dim=-1)[:, :t].cpu().numpy()
