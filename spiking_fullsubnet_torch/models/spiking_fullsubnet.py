"""Spiking-FullSubNet: configuration, module and entry point (counterpart of
``spiking_fullsubnet_tpu/models/spiking_fullsubnet.py``).

The port covers:
- ``scan_mode="layered"`` (the default, as ``separator_config`` leaves it)
  and whatever ``"auto"`` sends there: STFT, the laplace norms, the
  fullband and sub-band sequence models, the deep filter and the iSTFT,
  every layer's spikes returned. In eval every GSU stack runs on kernel F
  (``ops/gsu_kernels.gsu_stack_eval_x``); with ``train=True`` every GSU
  layer runs on kernels D and E (``ops/gsu.GSULayerTrain``), the forward is
  differentiable and the new BN running statistics are returned;
- serving through ``scan_mode="auto"`` (``models/stream_forward.py``) with
  ``collect_layer_outputs=False``: pre-LayerNorm (the flagship preset,
  ``models/presets.flagship_m``), the cumulative laplace norm and no norm on
  the whole-model monolith (kernel C) where its gate admits the config;
  every other config, the shipped zoo checkpoints' offline laplace norm
  (``separator_config(norm_type="offline_laplace_norm", shared_weights=True,
  bn=True)``) among them, on the two-launch path (kernels A, B);
- with ``collect_layer_outputs=True`` (the default) on ``"auto"``: the
  stream path's per-section forward, every GSU stack on kernel A, and the
  synops lists of every layer;
- training through the stream path (``scan_mode="stream"``, and
  ``"auto"`` on a CUDA tensor, as the JAX package on its chip): every GSU
  layer on kernels D and E with streams in the compute type (bfloat16
  under the bf16 policy), the glue in autograd;
- ``scan_mode="fused"`` (the flagship recipes' setting) and what
  ``"auto"`` sends there in eval (``models/fused_forward.py``): the single
  scan over frames on a CPU tensor, the layered formulation's kernels on a
  CUDA tensor;
- the layered path's other backbones and sub-band forms: the LIF and ALIF
  sequence models (``ops/lif.py``, plain PyTorch), the shared sub-band
  ablation (``sb_shared_bottleneck``, ``models/shared_subband.py``: one GSU
  stack over every section's units, kernel F in eval, D and E in
  training), and every feature norm of ``dsp/feature_norm.py``.
Weights come from a JAX-package ``.npz`` (``SpikingFullSubNet.from_npz``)
or from a seeded init (``SpikingFullSubNet.from_init``, ``build``).
Anything else raises ``NotImplementedError`` naming, by title, the ROADMAP
item that will bring it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..dsp.feature_norm import norm_wrapper
from ..dsp.spectral import istft_complex, stft_complex
from ..nn.core import tree_map
from ..nn.module_tracer import module_scope
from ..ops.deep_filter import deep_filter
from ..ops.freq_unfold import freq_unfold
from ..runtime.convert import load_npz
from ..runtime.device import resolve_device
from .sequence_model import (SequenceModelConfig, df_coefficients, sequence_model_apply,
                             sequence_model_init, subband_sequence_model_apply)
from .shared_subband import shared_subband_forward, shared_subband_init


@dataclass(frozen=True)
class SpikingFullSubNetConfig:
    n_fft: int = 512
    hop_length: int = 128
    win_length: int = 512
    fdrc: float = 0.5
    fb_input_size: int = 64
    fb_hidden_size: int = 320
    fb_num_layers: int = 2
    fb_proj_size: int = 64
    fb_output_activate_function: Optional[str] = None
    sb_hidden_size: int = 224
    sb_num_layers: int = 2
    freq_cutoffs: Tuple[int, ...] = (0, 32, 128, 256)
    df_orders: Tuple[int, ...] = (5, 3, 1)
    center_freq_sizes: Tuple[int, ...] = (4, 32, 64)
    neighbor_freq_sizes: Tuple[int, ...] = (15, 15, 15)
    fb_center_freq_sizes: Optional[Tuple[int, ...]] = None
    fb_neighbor_freq_sizes: Optional[Tuple[int, ...]] = None
    use_pre_layer_norm_fb: bool = True
    use_pre_layer_norm_sb: bool = True
    norm_type: Optional[str] = None
    bn: bool = False
    shared_weights: bool = False
    sequence_model: str = "GSN"
    num_spks: int = 1
    sb_shared_bottleneck: Optional[int] = None
    # "bfloat16": bf16 streams and weights around f32 accumulation, membranes
    # and the deep-filter/iSTFT signal path
    compute_dtype: Optional[str] = None
    backend: str = "auto"
    data_axis: Optional[str] = None
    band_axis: Optional[str] = None
    scan_mode: str = "layered"
    collect_layer_outputs: bool = True

    @property
    def num_freqs(self) -> int:
        return self.n_fft // 2  # Nyquist dropped

    @property
    def num_sections(self) -> int:
        return len(self.center_freq_sizes)

    @property
    def fb_ctrs(self) -> Tuple[int, ...]:
        return self.fb_center_freq_sizes or self.center_freq_sizes

    @property
    def fb_nbrs(self) -> Tuple[int, ...]:
        return self.fb_neighbor_freq_sizes or tuple(0 for _ in self.center_freq_sizes)

    def fb_config(self) -> SequenceModelConfig:
        return SequenceModelConfig(
            input_size=self.fb_input_size,
            hidden_size=self.fb_hidden_size,
            num_layers=self.fb_num_layers,
            sequence_model=self.sequence_model,
            proj_size=self.fb_proj_size,
            shared_weights=self.shared_weights,
            output_activate_function=self.fb_output_activate_function or None,
            bn=self.bn,
            use_pre_layer_norm=self.use_pre_layer_norm_fb,
            compute_dtype=self.compute_dtype,
            backend=self.backend,
        )

    def sb_config(self, idx: int) -> SequenceModelConfig:
        ctr = self.center_freq_sizes[idx]
        nbr = self.neighbor_freq_sizes[idx]
        return SequenceModelConfig(
            input_size=(ctr + 2 * nbr) + (self.fb_ctrs[idx] + 2 * self.fb_nbrs[idx]),
            hidden_size=self.sb_hidden_size,
            num_layers=self.sb_num_layers,
            sequence_model=self.sequence_model,
            proj_size=2 * ctr * self.df_orders[idx] * self.num_spks,
            shared_weights=self.shared_weights,
            output_activate_function=None,
            bn=self.bn,
            use_pre_layer_norm=self.use_pre_layer_norm_sb,
            compute_dtype=self.compute_dtype,
            backend=self.backend,
        )


def separator_config(
    *,
    sr: int = 16000,
    n_fft: int = 512,
    hop_length: int = 128,
    win_length: int = 512,
    fdrc: float = 0.5,
    num_freqs: int = 256,
    fb_freqs: int = 64,
    freq_cutoffs: Sequence[int] = (32, 128),
    sb_num_center_freqs: Sequence[int] = (4, 32, 64),
    sb_num_neighbor_freqs: Sequence[int] = (15, 15, 15),
    fb_num_center_freqs: Sequence[int] = (4, 32, 64),
    fb_num_neighbor_freqs: Sequence[int] = (0, 0, 0),
    fb_hidden_size: int = 320,
    sb_hidden_size: int = 224,
    sb_df_orders: Sequence[int] = (5, 3, 1),
    sequence_model: str = "GSN",
    fb_output_activate_function=False,
    sb_output_activate_function=False,
    norm_type: str = "offline_laplace_norm",
    shared_weights: bool = False,
    bn: bool = False,
) -> SpikingFullSubNetConfig:
    """Map the frozen competition ``Separator`` arguments
    (model_low_freq.py:485-559) onto the unified config."""
    return SpikingFullSubNetConfig(
        n_fft=n_fft,
        hop_length=hop_length,
        win_length=win_length,
        fdrc=fdrc,
        fb_input_size=fb_freqs,
        fb_hidden_size=fb_hidden_size,
        fb_num_layers=2,
        fb_proj_size=fb_freqs,
        fb_output_activate_function=fb_output_activate_function or None,
        sb_hidden_size=sb_hidden_size,
        sb_num_layers=2,
        freq_cutoffs=(0, *freq_cutoffs, num_freqs),
        df_orders=tuple(sb_df_orders),
        center_freq_sizes=tuple(sb_num_center_freqs),
        neighbor_freq_sizes=tuple(sb_num_neighbor_freqs),
        fb_center_freq_sizes=tuple(fb_num_center_freqs),
        fb_neighbor_freq_sizes=tuple(fb_num_neighbor_freqs),
        use_pre_layer_norm_fb=False,
        use_pre_layer_norm_sb=False,
        norm_type=norm_type,
        bn=bn,
        shared_weights=shared_weights,
        sequence_model="GSN" if sequence_model in ("GSU", "GSN") else sequence_model,
        num_spks=1,
    )


def spiking_fullsubnet_init(seed: int, cfg: SpikingFullSubNetConfig, device=None):
    """(params, state) trees of the JAX package's ``spiking_fullsubnet_init``
    (same keys, shapes and float32 distributions; other bits), drawn on the
    CPU from ``seed`` and moved to ``device`` (default ``cuda``); with
    ``sb_shared_bottleneck`` the sub-band entries are the shared model's."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    fb_params, fb_state = sequence_model_init(gen, cfg.fb_config())
    if cfg.sb_shared_bottleneck:
        sb_params, sb_states = shared_subband_init(gen, cfg)
    else:
        sb_params, sb_states = [], []
        for i in range(cfg.num_sections):
            p, s = sequence_model_init(gen, cfg.sb_config(i))
            sb_params.append(p)
            sb_states.append(s)
    to_dev = lambda t: tree_map(lambda x: x.to(dev), t)  # noqa: E731
    return (to_dev({"fb": fb_params, "sb": sb_params}),
            to_dev({"fb": fb_state, "sb": sb_states}))


def spiking_fullsubnet_apply(cfg: SpikingFullSubNetConfig, params, state,
                             noisy_y: torch.Tensor, train: bool = False) -> Dict[str, Any]:
    """Forward: ``noisy_y [B, T]`` -> dict with ``enhanced_y`` (``[B, T]``,
    or ``[B, S, T]`` for ``num_spks > 1``), ``enhanced_mag [B, F, T]``
    (``num_spks == 1``; None on the monolith), the per-layer output lists
    (the layered path's always, the stream path's with
    ``collect_layer_outputs``) and ``state`` (the new BN running
    statistics with ``train``, else the state given). Runs on the device of
    ``noisy_y``: the kernels on a CUDA tensor, their plain versions on a CPU
    tensor."""
    from .stream_forward import spiking_fullsubnet_stream_forward, stream_supported

    if noisy_y.ndim != 2:
        raise ValueError(f"Input tensor must be 2D, but got {noisy_y.ndim}D.")
    scan_mode = cfg.scan_mode
    if scan_mode == "auto":
        # spiking_fullsubnet.py:251-275 with "a CUDA tensor" for
        # gsu_pallas.available(): eval takes the stream path when supported;
        # training takes it only on the card, and else the layered path
        fused_ok = (cfg.norm_type is None and cfg.sequence_model == "GSN"
                    and not cfg.sb_shared_bottleneck)
        if stream_supported(cfg) and (not train or noisy_y.is_cuda):
            scan_mode = "stream"
        elif fused_ok and not train:
            scan_mode = "fused"
        else:
            scan_mode = "layered"
    if scan_mode == "stream":
        return spiking_fullsubnet_stream_forward(cfg, params, state, noisy_y, train)
    if scan_mode == "fused":
        from .fused_forward import spiking_fullsubnet_fused_forward
        return spiking_fullsubnet_fused_forward(cfg, params, state, noisy_y, train)
    return _layered_forward(cfg, params, state, noisy_y, train)


def _subband_forward(cfg: SpikingFullSubNetConfig, params, state, noisy_mag: torch.Tensor,
                     fb_output: torch.Tensor, train: bool = False, fused: bool = False,
                     band=None):
    """Every section: unfold of the noisy magnitude and of the fullband
    output, the norm, the section's sequence model
    (``spiking_fullsubnet.py:188-230``). ``fused`` unfolds the fullband
    output as the fused forward gathers it (edges of the ``num_freqs``-bin
    spectrum, indices clamped to the tile). Returns (df coefficient tensors
    ``[B, df, S, N fc, T, 2]``, per-section layer outputs, states); with
    ``sb_shared_bottleneck`` the shared model's (``:197-202``). ``band``
    (the fused forward's band group, ``fused_forward.band_split``): each
    section runs this rank's units (``_band_sections``)."""
    if band is not None:
        return _band_sections(cfg, params, state, noisy_mag, fb_output, train, band)
    if cfg.sb_shared_bottleneck:
        return shared_subband_forward(cfg, params["sb"], state["sb"], noisy_mag, fb_output,
                                      train, fused)
    norm = norm_wrapper(cfg.norm_type) if cfg.norm_type else None
    df_coefs, all_layer_outputs, new_states = [], [], []
    for idx in range(cfg.num_sections):
        lo, hi = cfg.freq_cutoffs[idx], cfg.freq_cutoffs[idx + 1]
        noisy_sub = freq_unfold(noisy_mag, lo, hi, cfg.center_freq_sizes[idx],
                                cfg.neighbor_freq_sizes[idx])
        fb_sub = freq_unfold(fb_output, lo, hi, cfg.fb_ctrs[idx], cfg.fb_nbrs[idx],
                             cfg.num_freqs if fused else 0)
        sb_input = torch.cat([noisy_sub, fb_sub], dim=-2)  # [B, N, 1, w_tot, T]
        if norm is not None:
            sb_input = norm(sb_input)
        with module_scope(f"sb{idx}"):
            out, layers, ns = subband_sequence_model_apply(
                cfg.sb_config(idx), params["sb"][idx], state["sb"][idx], sb_input,
                cfg.df_orders[idx], cfg.num_spks, train)
        df_coefs.append(out)
        all_layer_outputs.append(layers)
        new_states.append(ns)
    return df_coefs, all_layer_outputs, new_states


def _band_sections(cfg: SpikingFullSubNetConfig, params, state, noisy_mag: torch.Tensor,
                   fb_output: torch.Tensor, train: bool, band):
    """``_subband_forward`` under a band split (``models/fused_forward.py``):
    each section's inputs padded to a multiple of the group's units, this
    rank's units as rows in (unit, utterance) order, so that its pad units
    are its last rows; its GSU stack on F in eval and on D and E in band
    mode in training (``ops/gsu.BandRows``: BN over the group's real rows,
    with the group's exchange on the peer route, ``AxisGroup.band_exchange``);
    its outputs and every layer's spikes gathered over the group in unit
    order, the pad units dropped. Returns what ``_subband_forward`` does."""
    from .fused_forward import band_units, gather_units
    from ..ops.gsu import BandRows

    df_coefs, all_layer_outputs, new_states = [], [], []
    B, T = noisy_mag.shape[0], noisy_mag.shape[-1]
    for idx in range(cfg.num_sections):
        lo, hi = cfg.freq_cutoffs[idx], cfg.freq_cutoffs[idx + 1]
        noisy_sub = freq_unfold(noisy_mag, lo, hi, cfg.center_freq_sizes[idx],
                                cfg.neighbor_freq_sizes[idx])
        fb_sub = freq_unfold(fb_output, lo, hi, cfg.fb_ctrs[idx], cfg.fb_nbrs[idx],
                             cfg.num_freqs)
        x = torch.cat([noisy_sub, fb_sub], dim=-2)  # [B, N, 1, w_tot, T]
        N = x.shape[1]
        per, first, real = band_units(N, band)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, 0, per * band.size - N))
        x = x[:, first:first + per].transpose(0, 1).reshape(per * B, -1, T)
        rows = BandRows(real * B, N * B, band.all_reduce,
                        band.band_exchange(x.device) if train and x.is_cuda else None)
        with module_scope(f"sb{idx}"):
            out, layers, ns = sequence_model_apply(cfg.sb_config(idx), params["sb"][idx],
                                                   state["sb"][idx], x, train, rows)
        out = gather_units(out.reshape(per, B, *out.shape[1:]), band, 0, N)
        df_coefs.append(df_coefficients(out.transpose(0, 1).reshape(B * N, *out.shape[2:]),
                                        B, N, cfg.df_orders[idx], cfg.num_spks))
        all_layer_outputs.append([
            gather_units(a.reshape(T, per, B, -1), band, 1, N).transpose(1, 2).reshape(T, B * N, -1)
            for a in layers])
        new_states.append(ns)
    return df_coefs, all_layer_outputs, new_states


def _layered_forward(cfg: SpikingFullSubNetConfig, params, state,
                     noisy_y: torch.Tensor, train: bool = False,
                     fused: bool = False) -> Dict[str, Any]:
    """The layered forward (``spiking_fullsubnet.py:287-361``): STFT,
    ``|X|^fdrc`` without the Nyquist bin, the fullband sequence model, its
    output tiled over the bins, the sections, the deep filter per section,
    the Nyquist passthrough and the iSTFT. In eval every GSU stack runs on
    kernel F (four launches for three sections); in training every layer on
    kernels D and E (eight of each for two-layer stacks). Every layer's
    spikes are returned. ``fused`` gives the fused forward's answer: the
    tile cut to ``num_freqs`` bins and gathered as the fused forward does
    (``fused_forward.py:313-324``), which differs from the layered forward's
    where the tile is not ``num_freqs`` bins wide (``fb_proj_size=0``).
    With ``sb_shared_bottleneck`` kernel F runs twice in eval (the fullband
    and the shared stack) and D and E once a layer of each in training.
    With ``fused`` under a band split (``fused_forward.band_split``) each
    section runs this rank's units (``_band_sections``)."""
    B, sequence_length = noisy_y.shape
    spec = stft_complex(noisy_y, cfg.n_fft, cfg.hop_length, cfg.win_length)  # [B, F+1, T]
    noisy_cmp = spec[:, None]  # [B, 1, F+1, T]
    noisy_mag = (spec.abs()[:, None] ** cfg.fdrc)[..., :-1, :]  # [B, 1, F, T]
    norm = norm_wrapper(cfg.norm_type) if cfg.norm_type else None
    # with no norm the glue between the stacks runs in the compute type,
    # as in the JAX package (:300-301); the deep-filter signal path stays
    # in the spectrum's type
    if cfg.compute_dtype is not None and norm is None:
        noisy_mag = noisy_mag.to(getattr(torch, cfg.compute_dtype))

    fb_input = noisy_mag[..., :cfg.fb_input_size, :]
    if norm is not None:
        fb_input = norm(fb_input)
    with module_scope("fb"):
        fb_output, fb_all_layer_outputs, new_fb_state = sequence_model_apply(
            cfg.fb_config(), params["fb"], state["fb"],
            fb_input.reshape(B, -1, fb_input.shape[-1]), train)
    num_repeats = (cfg.n_fft // 2 + 1) // cfg.fb_input_size
    fb_output = fb_output.to(noisy_mag.dtype)[:, None].repeat(1, 1, num_repeats, 1)
    if fused:
        fb_output = fb_output[:, :, :cfg.num_freqs]

    band = None
    if fused:
        from .fused_forward import band_split
        band = band_split(cfg)
    df_coefs, sb_all_layer_outputs, new_sb_states = _subband_forward(
        cfg, params, state, noisy_mag, fb_output, train, fused, band)

    enh_list, f0 = [], 0
    for df_coef, df_order in zip(df_coefs, cfg.df_orders):
        nf = df_coef.shape[3]
        enh_list.append(deep_filter(noisy_cmp[..., f0:f0 + nf, :], df_coef, df_order,
                                    cfg.num_spks))  # [B, 1, S, nf, T]
        f0 += nf
    nyq = noisy_cmp[..., -1:, :][:, :, None].expand(-1, -1, cfg.num_spks, -1, -1)
    enh_stft = torch.cat([torch.cat(enh_list, dim=-2), nyq], dim=-2)  # [B, 1, S, F+1, T]
    out = {"fb_all_layer_outputs": fb_all_layer_outputs,
           "sb_all_layer_outputs": sb_all_layer_outputs,
           "state": {"fb": new_fb_state, "sb": new_sb_states}}
    flat = enh_stft.reshape(B * cfg.num_spks, *enh_stft.shape[-2:])
    enh_y = istft_complex(flat, cfg.n_fft, cfg.hop_length, cfg.win_length,
                          length=sequence_length)
    if cfg.num_spks > 1:
        out["enhanced_y"] = enh_y.reshape(B, cfg.num_spks, -1)
    else:
        out["enhanced_y"] = enh_y
        out["enhanced_mag"] = flat.abs()
    return out


# --------------------------------------------------------------- module


def _tree_module(tree, as_param: bool) -> nn.Module:
    """Nested modules mirroring a JAX pytree: dict keys become submodule
    names, lists ModuleLists, tensor leaves trainable parameters (as_param)
    or buffers."""
    m = nn.ModuleList() if isinstance(tree, list) else nn.Module()
    for k, v in (enumerate(tree) if isinstance(tree, list) else tree.items()):
        if not isinstance(v, torch.Tensor):
            m.add_module(str(k), _tree_module(v, as_param))
        elif as_param:
            m.register_parameter(str(k), nn.Parameter(v))
        else:
            m.register_buffer(str(k), v)
    return m


def _tree_of(m: nn.Module):
    """The nested dict/list tree of tensors a ``_tree_module`` holds."""
    if isinstance(m, nn.ModuleList):
        return [_tree_of(c) for c in m]
    out = dict(m.named_parameters(recurse=False))
    out.update(m.named_buffers(recurse=False))
    out.update({k: _tree_of(c) for k, c in m.named_children()})
    return out


class SpikingFullSubNet(nn.Module):
    """Weights and BN running statistics under the JAX path names: the
    ``state_dict`` keys are the ``.npz`` keys with dots
    (``params.fb.stack.layers.0.weight_hh``,
    ``state.sb.1.stack.layers.0.bn.running_mean``). ``forward`` is the
    no-grad eval ``spiking_fullsubnet_apply`` on them; training takes
    ``param_tree()``/``state_tree()`` to ``recipes.denoise.train_step``
    with ``self.parameters()`` in the optimizer."""

    def __init__(self, cfg: SpikingFullSubNetConfig, params, state):
        super().__init__()
        self.cfg = cfg
        self.params = _tree_module(params, as_param=True)
        self.state = _tree_module(state, as_param=False)

    @classmethod
    def from_init(cls, cfg: SpikingFullSubNetConfig, seed: int = 0,
                  device=None) -> "SpikingFullSubNet":
        """Random weights from ``seed`` (``spiking_fullsubnet_init``) on
        ``device`` (default ``cuda``)."""
        params, state = spiking_fullsubnet_init(seed, cfg, device=device)
        return cls(cfg, params, state)

    @classmethod
    def from_npz(cls, path: str, cfg: SpikingFullSubNetConfig, device=None) -> "SpikingFullSubNet":
        """Load a JAX-package ``.npz`` (``params/...``, ``state/...``) onto
        ``device`` (default ``cuda``)."""
        tree = load_npz(path, device=device)
        return cls(cfg, tree["params"], tree["state"])

    def param_tree(self):
        """The weights as the nested dict/list tree the functions take."""
        return _tree_of(self.params)

    def state_tree(self):
        return _tree_of(self.state)

    @torch.no_grad()
    def forward(self, noisy_y: torch.Tensor) -> Dict[str, Any]:
        return spiking_fullsubnet_apply(self.cfg, self.param_tree(), self.state_tree(), noisy_y)


# --------------------------------------------------------------- TOML builder


def _norm_cfg_args(model_args: dict) -> dict:
    """TOML arg normalization: lists -> tuples, false -> None for activations."""
    out = {}
    for k, v in model_args.items():
        if isinstance(v, list):
            v = tuple(v)
        if k.endswith("activate_function") and v is False:
            v = None
        out[k] = v
    return out


def _bundle(cfg: SpikingFullSubNetConfig, seed: int, device) -> Dict[str, Any]:
    params, state = spiking_fullsubnet_init(seed, cfg, device=device)
    return {"config": cfg, "apply": spiking_fullsubnet_apply, "params": params, "state": state}


def build(seed: int = 0, device=None, **model_args) -> Dict[str, Any]:
    """Model bundle from [model] args: ``config``, ``apply``, ``params``,
    ``state`` (as the JAX package's ``build``), the weights on ``device``."""
    return _bundle(SpikingFullSubNetConfig(**_norm_cfg_args(model_args)), seed, device)


def build_separator(seed: int = 0, device=None, **model_args) -> Dict[str, Any]:
    """Bundle for the frozen competition arg surface (``separator_config``)."""
    return _bundle(separator_config(**_norm_cfg_args(model_args)), seed, device)
