"""Stream (serve) forward, eval, two-launch path (counterpart of
``spiking_fullsubnet_tpu/models/stream_forward.py``).

The pipeline is time-major ``[T, B, ...]`` from the STFT to the iSTFT:

1. STFT as a windowed-DFT matmul (``dsp/spectral.py``), ``mag = |X|^fdrc``
   without the Nyquist bin;
2. the offline laplace norm of the fullband input (one scalar per utterance
   over the real frames), the hoisted layer-0 fullband matmul, **kernel A**
   (``ops/gsu_kernels.gsu_stack_eval``) for the fullband stack, and the
   fullband projection;
3. the merged sub-band build: each unit's frequency unfold (reflect padding
   and the fullband tile included) is folded into one-hot scattered layer-0
   weights over a window of the magnitude and over the fullband output, and
   the projection's columns are permuted to (c, d, fc) order so that every
   deep-filter tap is a contiguous slice;
4. one statistics sweep gives every unit's offline-norm scale, then
   **kernel B** (``ops/gsu_kernels.gsu_sections_eval``) runs all sections,
   their projection and the deep filter;
5. the Nyquist bin passes through and the iSTFT gives the audio.

The TPU layout padding of the JAX package (``Tp = round_up(T, 128)``,
128-lane gate and projection widths) is gone: the port runs at the real T,
H and G, and its statistics are over the real frames only.

Covered: eval, ``collect_layer_outputs=False``, ``norm_type=
"offline_laplace_norm"`` without pre-LayerNorm (the zoo checkpoints). The
causal-norm and pre-LN configurations take the monolith kernel in the JAX
package and raise ``NotImplementedError`` here until it is ported.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..dsp.mask import EPSILON
from ..dsp.spectral import istft_real_imag_tmajor, num_frames, stft_real_imag_tmajor
from ..nn.core import cast_floating, output_activation
from ..ops.gsu_kernels import gsu_sections_eval, gsu_stack_eval, pack_stack
from .fused_forward import _reflect_unfold_indices


def stream_supported(cfg) -> bool:
    """Static config gate of the stream path (``stream_forward.py:97-127``)."""
    norm_ok = cfg.norm_type in (None, "offline_laplace_norm", "cumulative_laplace_norm")
    no_ln_with_norm = cfg.norm_type is None or not (
        cfg.use_pre_layer_norm_fb or cfg.use_pre_layer_norm_sb)
    return (
        norm_ok
        and no_ln_with_norm
        and cfg.sequence_model == "GSN"
        and not cfg.sb_shared_bottleneck
        and cfg.num_spks == 1
        and cfg.data_axis is None
        and cfg.band_axis is None
        and cfg.fb_proj_size > 0
    )


def _one_hot_scatter(idx: np.ndarray, width: int) -> np.ndarray:
    """``[N, w, width]`` one-hot of per-unit input lane -> source bin
    (reflect duplicates accumulate, as the unfold does)."""
    n, w = idx.shape
    oh = np.zeros((n, w, width), np.float64)
    oh[np.arange(n)[:, None], np.arange(w)[None, :], idx] = 1.0
    return oh


def _check_covered(cfg) -> None:
    if not stream_supported(cfg):
        raise ValueError("stream forward: unsupported config (see stream_supported)")
    if cfg.collect_layer_outputs:
        raise NotImplementedError(
            "collect_layer_outputs=True (per-layer spike tensors for synops) is not "
            "ported yet (ROADMAP queue 2: the collect path, kernel A's 4-D form)")
    if cfg.norm_type != "offline_laplace_norm":
        raise NotImplementedError(
            f"norm_type={cfg.norm_type!r} serves on the whole-model monolith kernel, "
            "not ported yet (ROADMAP queue 2, kernel C)")


def _section_specs(cfg, sb_params, sb_states, io: torch.dtype, acc: torch.dtype):
    """Kernel-B section dicts plus the statistics selectors.

    Returns (secs, sel_mag [F, U], sel_fb [fb_proj, U], unit_groups) where
    unit_groups lists (u0, n, w_tot) per section."""
    full_f = cfg.num_freqs
    H = cfg.sb_hidden_size
    dev = sb_params[0]["proj"]["weight"].device
    secs: List[Dict[str, Any]] = []
    sel_cols_m, sel_cols_f, groups = [], [], []
    u0 = 0
    for i in range(cfg.num_sections):
        lo, hi = cfg.freq_cutoffs[i], cfg.freq_cutoffs[i + 1]
        ctr, nbr, df = cfg.center_freq_sizes[i], cfg.neighbor_freq_sizes[i], cfg.df_orders[i]
        n = (hi - lo) // ctr
        w_noisy = ctr + 2 * nbr
        w_tot = w_noisy + cfg.fb_ctrs[i] + 2 * cfg.fb_nbrs[i]
        idx_noisy = _reflect_unfold_indices(lo, hi, ctr, nbr, full_f)  # [n, w_noisy]
        idx_fb = _reflect_unfold_indices(
            lo, hi, cfg.fb_ctrs[i], cfg.fb_nbrs[i], full_f) % cfg.fb_proj_size
        a, b = int(idx_noisy.min()), int(idx_noisy.max()) + 1
        oh_n = torch.as_tensor(_one_hot_scatter(idx_noisy - a, b - a), dtype=acc, device=dev)
        oh_f = torch.as_tensor(_one_hot_scatter(idx_fb, cfg.fb_proj_size), dtype=acc, device=dev)

        p = sb_params[i]
        w_t0 = p["stack"]["layers"][0]["weight_ih"].T.to(acc)  # [w_tot, G]
        # scatter[n, p, j] = sum_w onehot[n, w, p] W[w, j], rounded once to io
        wa = torch.einsum("nwp,wj->npj", oh_n, w_t0[:w_noisy]).to(io).contiguous()
        wb = torch.einsum("nwp,wj->npj", oh_f, w_t0[w_noisy:]).to(io).contiguous()
        # projection rows from (c, fc, d) to (c, d, fc) order:
        # new[(c*df + d)*ctr + fc] = old[(c*ctr + fc)*df + d]
        src = (np.arange(2)[:, None, None] * ctr * df
               + np.arange(ctr)[None, None, :] * df
               + np.arange(df)[None, :, None]).reshape(-1)
        src_t = torch.as_tensor(src, device=dev)
        wihr, whh, coef = pack_stack(p["stack"]["layers"], sb_states[i]["stack"]["layers"],
                                     H, io)
        secs.append({
            "wa": wa, "a0": a, "wb": wb, "wihr": wihr, "whh": whh, "coef": coef,
            "wproj": p["proj"]["weight"][src_t].T.to(io).contiguous(),
            "bproj": p["proj"]["bias"][src_t].to(acc).contiguous(),
            "ctr": ctr, "df": df,
        })
        sel_cols_m.append(_one_hot_scatter(idx_noisy, full_f).sum(axis=1).T)  # [F, n]
        sel_cols_f.append(oh_f.sum(dim=1).T)  # [fb_proj, n]
        groups.append((u0, n, w_tot))
        u0 += n
    sel_mag = torch.as_tensor(np.concatenate(sel_cols_m, axis=1), dtype=acc, device=dev)
    return secs, sel_mag, torch.cat(sel_cols_f, dim=1), groups


@torch.no_grad()
def spiking_fullsubnet_stream_forward(cfg, params, state, noisy_y: torch.Tensor):
    """Eval forward in stream layout; same output dict as the JAX package
    (``enhanced_y [B, T]``, ``enhanced_mag [B, F+1, T]``, empty per-layer
    output lists, ``state`` unchanged)."""
    _check_covered(cfg)
    if noisy_y.ndim != 2:
        raise ValueError(f"Input tensor must be 2D, but got {noisy_y.ndim}D.")
    B, sequence_length = noisy_y.shape
    mixed = cfg.compute_dtype is not None
    compute = getattr(torch, cfg.compute_dtype) if mixed else noisy_y.dtype
    acc = torch.float32 if mixed else noisy_y.dtype
    dft_dtype = compute if mixed else None
    H_fb, shared = cfg.fb_hidden_size, cfg.shared_weights
    full_f = cfg.num_freqs

    # ---- STFT, magnitude ----
    T = num_frames(sequence_length, cfg.n_fft, cfg.hop_length)
    re_t, im_t = stft_real_imag_tmajor(
        noisy_y, cfg.n_fft, cfg.hop_length, cfg.win_length, matmul_dtype=dft_dtype)
    re_t, im_t = re_t.contiguous(), im_t.contiguous()  # [T, B, F+1]
    mag_t = ((re_t.square() + im_t.square()) ** (cfg.fdrc / 2))[..., :full_f]
    mag_t = mag_t.to(compute).contiguous()  # [T, B, F]

    fb_params = cast_floating(params["fb"], compute) if mixed else params["fb"]
    sb_params = [cast_floating(p, compute) if mixed else p for p in params["sb"]]

    # ---- fullband: offline laplace norm, hoisted layer 0, kernel A ----
    fb_in = mag_t[..., :cfg.fb_input_size].to(acc)
    mu_fb = fb_in.sum(dim=-1).sum(dim=0) / (cfg.fb_input_size * T)  # [B]
    fb_ln = (fb_in / (mu_fb[None, :, None] + EPSILON)).to(compute)
    w0_fb = fb_params["stack"]["layers"][0]["weight_ih"].T.to(acc)
    xg0_fb = (fb_ln.reshape(T * B, -1).to(acc) @ w0_fb).reshape(T, B, -1).to(compute)
    wihr, whh, coef = pack_stack(fb_params["stack"]["layers"],
                                 state["fb"]["stack"]["layers"], H_fb, compute)
    fb_spikes = gsu_stack_eval(xg0_fb.contiguous(), wihr, whh, coef, H_fb, shared)
    fb_proj = (fb_spikes.to(acc) @ fb_params["proj"]["weight"].T.to(acc)
               + fb_params["proj"]["bias"].to(acc))  # [T, B, fb_proj]
    fb_act_c = output_activation(cfg.fb_output_activate_function)(fb_proj).to(compute)

    # ---- sub-band sections: statistics sweep, kernel B ----
    secs, sel_mag, sel_fb, groups = _section_specs(
        cfg, sb_params, state["sb"], compute, acc)
    s1 = mag_t.to(acc) @ sel_mag + fb_act_c.to(acc) @ sel_fb  # [T, B, U]
    sec_sum = s1.sum(dim=0)  # [B, U]
    alpha = torch.cat([
        (1.0 / (sec_sum[:, u0:u0 + n].sum(dim=-1) / (n * w_tot * T) + EPSILON))[:, None]
        .expand(B, n)
        for u0, n, w_tot in groups], dim=1).contiguous()
    enh_re, enh_im = gsu_sections_eval(
        secs, mag_t, fb_act_c.contiguous(), alpha, re_t, im_t, cfg.sb_hidden_size, shared)

    # ---- Nyquist passthrough + iSTFT ----
    out_re = torch.cat([enh_re, re_t[..., full_f:]], dim=-1)
    out_im = torch.cat([enh_im, im_t[..., full_f:]], dim=-1)
    enhanced_y = istft_real_imag_tmajor(
        out_re, out_im, cfg.n_fft, cfg.hop_length, cfg.win_length,
        length=sequence_length, matmul_dtype=dft_dtype)
    enhanced_mag = torch.sqrt(out_re.square() + out_im.square()).permute(1, 2, 0)
    return {
        "enhanced_y": enhanced_y,
        "enhanced_mag": enhanced_mag,
        "fb_all_layer_outputs": [],
        "sb_all_layer_outputs": [],
        "state": state,
    }
