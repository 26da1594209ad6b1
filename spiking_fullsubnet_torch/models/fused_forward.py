"""The fused forward of Spiking-FullSubNet (counterpart of
``spiking_fullsubnet_tpu/models/fused_forward.py``, ``scan_mode="fused"``).

The JAX package runs the whole causal pipeline, the fullband stack, the
per-frame unfold of its output and every sub-band section, as one scan over
frames, which cuts the TPU's scan dispatch eightfold. Its math is the
layered forward's op for op (the JAX tests hold the two equal to 1e-12 in
f64, outputs, BN state and synops alike); only the input products are
summed per frame instead of over ``T * B``. Two routes here:

- ``fused_forward_plain``, the single scan written out as a loop over
  frames on tensors: the oracle, and the route of a CPU tensor. The hoisted
  STFT, fullband pre-LN and layer 0's gates; the noisy unfolds per section
  and the static gather of the fullband output per frame; per frame every
  GSU cell (batch statistics BN in training, the folded running statistics
  in eval, the triangle surrogate through ``ops/gsu.Spike``); the running
  statistics in closed form, the synops lists folded ``t n b w -> t (b n)
  w``, the deep filter, the Nyquist passthrough and the iSTFT. Under the
  bf16 policy weights and glue are in ``compute_dtype``, accumulators,
  membranes and the signal path in float32.
- on a CUDA tensor, ``fused_forward_layered``, the layered formulation
  (``spiking_fullsubnet._layered_forward``) with the fused forward's
  fullband gather: on the card each GSU stack already runs over all frames
  in one launch, so the stacks run in dependency order, the fullband then
  the three sections, on kernel F in eval and on kernels D, E and dW per
  layer in training. It returns the same dict (``enhanced_mag`` included,
  which the GAN generator step reads).

The JAX package's band/data mesh sharding (padded sections, BN row masks)
has no single-GPU counterpart: ``band_axis`` or ``data_axis`` raises.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..dsp.spectral import istft_complex, stft_complex
from ..nn.core import cast_floating, layer_norm_apply, linear_apply, output_activation
from ..ops.deep_filter import deep_filter
from ..ops.freq_unfold import freq_unfold, reflect_unfold_indices
from ..ops.gsu import BN_EPS, bn_running_update, spike


def check_fused(cfg) -> None:
    """The configs the fused forward takes (``fused_forward.py:136-139``)."""
    if cfg.norm_type is not None:
        raise ValueError("fused scan supports norm_type=None (latest generation) only")
    if cfg.sequence_model != "GSN":
        raise ValueError("fused scan supports the GSN backbone only")
    if cfg.band_axis or cfg.data_axis:
        raise NotImplementedError(
            "the fused forward's band/data mesh sharding is not ported yet "
            "(ROADMAP queue 1: distributed training)")


def spiking_fullsubnet_fused_forward(cfg, params, state, noisy_y: torch.Tensor,
                                     train: bool = False) -> Dict[str, Any]:
    """``scan_mode="fused"``: the layered apply's output dict. A CUDA tensor
    runs the layered formulation on the kernels, a CPU tensor the single
    scan written out (``fused_forward_plain``)."""
    if noisy_y.is_cuda:
        return fused_forward_layered(cfg, params, state, noisy_y, train)
    return fused_forward_plain(cfg, params, state, noisy_y, train)


def fused_forward_layered(cfg, params, state, noisy_y: torch.Tensor,
                          train: bool = False) -> Dict[str, Any]:
    """The fused forward as the layered formulation, stack after stack: the
    fullband tile cut to ``num_freqs`` bins and gathered with the fused
    forward's clamped indices, so that it is the fused forward's answer also
    where that differs from the layered forward's (``fb_proj_size=0``). The
    route of a CUDA tensor; on a CPU tensor the kernels' plain versions."""
    from .spiking_fullsubnet import _layered_forward
    check_fused(cfg)
    return _layered_forward(cfg, params, state, noisy_y, train, fused=True)


def _cell_step(lp, xg_t, rg_in, hidden: int, shared: bool, c, acc, bn_mode, bn_aux, cdt):
    """One GSU cell step (``fused_forward.py:67-111``): ``xg_t`` the input
    gates in ``acc``, ``rg_in`` the recurrent spikes; the leading axes are
    batch axes. Returns (spikes in ``cdt``, the membrane after BN, the
    step's (mean, biased variance) in training)."""
    rg = rg_in.to(acc) @ lp["weight_hh"].to(acc).T
    b = lp["bias_ih"].to(acc)
    if shared:
        f_in = xg_t + rg + b[:hidden]
        c_in = xg_t + rg + b[hidden:]
    else:
        f_in = xg_t[..., :hidden] + rg[..., :hidden] + b[:hidden]
        c_in = xg_t[..., hidden:] + rg[..., hidden:] + b[hidden:]
    f = torch.sigmoid(f_in)
    cy = f * c + (1.0 - f) * c_in
    stats = None
    if bn_mode == "train":
        axes = tuple(range(cy.ndim - 1))
        mean = cy.mean(dim=axes)
        var = (cy - mean).square().mean(dim=axes)
        cy = (cy - mean) * torch.rsqrt(var + BN_EPS) * bn_aux[0] + bn_aux[1]
        stats = (mean, var)
    elif bn_mode == "eval":
        cy = cy * bn_aux[0] + bn_aux[1]
    return spike(cy).to(cdt), cy, stats


def _bn_aux(params, state, train: bool, acc):
    """Each layer's (mode, BN terms): the affine in training, the running
    statistics folded into a scale and a shift in eval, None without BN."""
    out = []
    for lp, ls in zip(params["stack"]["layers"], state["stack"]["layers"]):
        if "bn" not in lp:
            out.append((None, None))
        elif train:
            out.append(("train", (lp["bn"]["weight"].to(acc), lp["bn"]["bias"].to(acc))))
        else:
            rv, rm = ls["bn"]["running_var"], ls["bn"]["running_mean"]
            scale = lp["bn"]["weight"].to(rv.dtype) * torch.rsqrt(rv + BN_EPS)
            shift = lp["bn"]["bias"].to(rv.dtype) - rm * scale
            out.append(("eval", (scale.to(acc), shift.to(acc))))
    return out


def _stack_step(params, aux, carry: List, x_t, xg0_t, hidden: int, shared: bool, acc, cdt):
    """Every layer of a stack at one frame. ``carry`` holds each layer's
    (spikes, membrane) and is updated in place; returns every layer's
    spikes and statistics."""
    spikes, stats, o = [], [], x_t
    for li, (lp, (mode, bn)) in enumerate(zip(params["stack"]["layers"], aux)):
        xg = xg0_t if li == 0 and xg0_t is not None else o.to(acc) @ lp["weight_ih"].to(acc).T
        h, c = carry[li]
        o, cy, st = _cell_step(lp, xg, h, hidden, shared, c, acc, mode, bn, cdt)
        carry[li] = (o, cy)
        spikes.append(o)
        stats.append(st)
    return spikes, stats


def _new_stack_state(state, stats, rows: int):
    """The stack's running statistics from its per-frame batch statistics."""
    return {"stack": {"layers": [
        {"bn": bn_running_update(ls["bn"], torch.stack([s[0] for s in st]),
                                 torch.stack([s[1] for s in st]), rows)}
        for ls, st in zip(state["stack"]["layers"], stats)]}}


def fused_forward_plain(cfg, params, state, noisy_y: torch.Tensor,
                        train: bool = False) -> Dict[str, Any]:
    """The single scan over frames (``fused_forward.py:130-440``) as a loop
    over frames, on any device; differentiable."""
    check_fused(cfg)
    B, sequence_length = noisy_y.shape
    cdt = getattr(torch, cfg.compute_dtype) if cfg.compute_dtype else noisy_y.dtype
    acc = torch.float32 if cfg.compute_dtype else noisy_y.dtype
    shared = cfg.shared_weights
    S = cfg.num_sections

    spec = stft_complex(noisy_y, cfg.n_fft, cfg.hop_length, cfg.win_length)  # [B, F+1, T]
    noisy_cmp = spec[:, None]
    noisy_mag = (spec.abs()[:, None] ** cfg.fdrc)[..., :-1, :]  # [B, 1, 256, T]
    T = noisy_mag.shape[-1]

    fb_cfg = cfg.fb_config()
    sb_cfgs = [cfg.sb_config(i) for i in range(S)]
    cast = (lambda p: cast_floating(p, cdt)) if cfg.compute_dtype else (lambda p: p)
    fb_p = cast(params["fb"])
    sb_p = [cast(params["sb"][i]) for i in range(S)]

    # hoisted: the fullband input, its pre-LN and layer 0's gates over [T B, F]
    fb_in = noisy_mag[:, 0, :cfg.fb_input_size].permute(2, 0, 1).to(cdt)  # [T, B, F]
    if fb_cfg.use_pre_layer_norm:
        fb_in = layer_norm_apply(fb_p["pre_ln"], fb_in)
    w0 = fb_p["stack"]["layers"][0]["weight_ih"]
    xg_fb0 = (fb_in.reshape(T * B, -1).to(acc) @ w0.to(acc).T).reshape(T, B, -1)

    # hoisted: the noisy unfolds per section [T, N, B, w], and the static
    # indices of the per-frame fullband-output gather [N, w_fb]
    noisy_sub, sub_rows, fb_idx = [], [], []
    for i in range(S):
        lo, hi = cfg.freq_cutoffs[i], cfg.freq_cutoffs[i + 1]
        ns = freq_unfold(noisy_mag, lo, hi, cfg.center_freq_sizes[i], cfg.neighbor_freq_sizes[i])
        n = ns.shape[1]
        noisy_sub.append(ns.permute(4, 1, 0, 2, 3).reshape(T, n, B, -1).to(cdt))
        sub_rows.append(B * n)
        fb_idx.append(torch.as_tensor(reflect_unfold_indices(
            lo, hi, cfg.fb_ctrs[i], cfg.fb_nbrs[i], cfg.num_freqs), device=noisy_y.device))
    num_repeats = (cfg.n_fft // 2 + 1) // cfg.fb_input_size

    fb_aux = _bn_aux(fb_p, state["fb"], train, acc)
    sb_aux = [_bn_aux(sb_p[i], state["sb"][i], train, acc) for i in range(S)]

    def zeros(shape, h):
        return (torch.zeros(*shape, h, dtype=cdt, device=noisy_y.device),
                torch.zeros(*shape, h, dtype=acc, device=noisy_y.device))

    fb_carry = [zeros((B,), cfg.fb_hidden_size) for _ in range(fb_cfg.num_layers)]
    sb_carry = [[zeros((noisy_sub[i].shape[1], B), cfg.sb_hidden_size)
                 for _ in range(sb_cfgs[i].num_layers)] for i in range(S)]
    fb_spikes = [[] for _ in range(fb_cfg.num_layers)]
    fb_stats = [[] for _ in range(fb_cfg.num_layers)]
    fb_outs = []
    sb_inputs = [[] for _ in range(S)]
    sb_spikes = [[[] for _ in range(c.num_layers)] for c in sb_cfgs]
    sb_stats = [[[] for _ in range(c.num_layers)] for c in sb_cfgs]
    sb_outs = [[] for _ in range(S)]

    for t in range(T):
        spk, st = _stack_step(fb_p, fb_aux, fb_carry, None, xg_fb0[t], cfg.fb_hidden_size,
                              shared, acc, cdt)
        for li in range(fb_cfg.num_layers):
            fb_spikes[li].append(spk[li])
            fb_stats[li].append(st[li])
        # the synops record the projection before its activation; the tiled
        # fullband feature is after it (sequence_model.py:119-125)
        fb_proj = linear_apply(fb_p["proj"], spk[-1]) if fb_cfg.proj_size > 0 else spk[-1]
        fb_outs.append(fb_proj.to(acc))
        fb_act = output_activation(fb_cfg.output_activate_function)(fb_proj)
        fb_full = fb_act.repeat(1, num_repeats)[:, :cfg.num_freqs]  # [B, 256]
        for i in range(S):
            # an index past a narrower tile (fb_proj_size 0 with a small
            # fullband) reads its last bin, as JAX's gather clamps it
            idx = fb_idx[i].clamp(max=fb_full.shape[1] - 1)
            fb_sub = fb_full[:, idx].transpose(0, 1)  # [N, B, w_fb]
            x_t = torch.cat([noisy_sub[i][t], fb_sub], dim=-1)
            if sb_cfgs[i].use_pre_layer_norm:
                x_t = layer_norm_apply(sb_p[i]["pre_ln"], x_t)
            sb_inputs[i].append(x_t)
            spk, st = _stack_step(sb_p[i], sb_aux[i], sb_carry[i], x_t, None,
                                  cfg.sb_hidden_size, shared, acc, cdt)
            for li in range(sb_cfgs[i].num_layers):
                sb_spikes[i][li].append(spk[li])
                sb_stats[i][li].append(st[li])
            sb_outs[i].append(linear_apply(sb_p[i]["proj"], spk[-1]).to(acc))

    new_state = state
    if train and cfg.bn:
        new_state = {"fb": _new_stack_state(state["fb"], fb_stats, B),
                     "sb": [_new_stack_state(state["sb"][i], sb_stats[i], sub_rows[i])
                            for i in range(S)]}

    def fold(frames):  # T x [N, B, w] -> [T, B N, w]
        x = torch.stack(frames)
        return x.transpose(1, 2).reshape(T, -1, x.shape[-1])

    fb_all_layer_outputs = [fb_in] + [torch.stack(s) for s in fb_spikes]
    if fb_cfg.proj_size > 0:
        fb_all_layer_outputs.append(torch.stack(fb_outs))
    sb_all_layer_outputs = [[fold(sb_inputs[i])] + [fold(s) for s in sb_spikes[i]]
                            + [fold(sb_outs[i])] for i in range(S)]

    # the deep filter per section, the Nyquist passthrough and the iSTFT
    enh_list, f0 = [], 0
    for i, df_order in enumerate(cfg.df_orders):
        act = output_activation(sb_cfgs[i].output_activate_function)
        out = act(torch.stack(sb_outs[i]))  # [T, N, B, (c fc df s)]
        N = out.shape[1]
        out = out.reshape(T, N, B, 2, -1, df_order, cfg.num_spks)
        coef = out.permute(2, 5, 6, 1, 4, 0, 3).reshape(B, df_order, cfg.num_spks, -1, T, 2)
        nf = coef.shape[3]
        enh_list.append(deep_filter(noisy_cmp[..., f0:f0 + nf, :], coef, df_order,
                                    cfg.num_spks))
        f0 += nf
    nyq = noisy_cmp[..., -1:, :][:, :, None].expand(-1, -1, cfg.num_spks, -1, -1)
    enh_stft = torch.cat([torch.cat(enh_list, dim=-2), nyq], dim=-2)  # [B, 1, S, F+1, T]
    flat = enh_stft.reshape(B * cfg.num_spks, *enh_stft.shape[-2:])
    enh_y = istft_complex(flat, cfg.n_fft, cfg.hop_length, cfg.win_length,
                          length=sequence_length)
    out = {"fb_all_layer_outputs": fb_all_layer_outputs,
           "sb_all_layer_outputs": sb_all_layer_outputs, "state": new_state}
    if cfg.num_spks > 1:
        out["enhanced_y"] = enh_y.reshape(B, cfg.num_spks, -1)
    else:
        out["enhanced_y"] = enh_y
        out["enhanced_mag"] = flat.abs()
    return out
