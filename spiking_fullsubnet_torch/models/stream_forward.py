"""Stream (serve) forward, eval (counterpart of
``spiking_fullsubnet_tpu/models/stream_forward.py``). Two serving paths, as
the JAX package dispatches them (``stream_forward.py:734-759``):

**Monolith** (norms "ln" = pre-LayerNorm, "cum" = cumulative laplace norm,
"raw" = none; the flagship preset): the audio is left-padded by n_fft/2 and
cut into hop chunks, and **kernel C** (``ops/gsu_kernels.
sfsb_monolith_serve``) runs the whole model per step: windowed DFT,
``|X|^0.5``, the norm statistics, the fullband stack and projection, every
unit's layer-0 gates, the section stacks, projection and deep filter, the
inverse DFT and the overlap-add. Here around it: the LN fold into the
layer-0 weights (``_fold_ln``), the one-hot scatter of each unit's unfold
into its weights, the statistics columns, the chunking, the trim and the
COLA start- and end-edge corrections.

**Two-launch** (the offline laplace norm without pre-LN: the zoo
checkpoints; time-major ``[T, B, ...]`` from the STFT to the iSTFT):

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
128-lane gate, projection and spectrum widths, 128-aligned windows, batch
rows padded to 8) is gone: the port runs at the real T (the monolith runs
exactly T + 3 steps), H, G and window widths.

Covered: eval, ``collect_layer_outputs=False``. A causal-norm or pre-LN
config that misses the monolith's gate would take kernel B's pre-LN and
per-frame alpha/beta terms, which are not ported yet, and raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.mask import EPSILON
from ..dsp.spectral import istft_real_imag_tmajor, num_frames, stft_real_imag_tmajor
from ..nn.core import cast_floating, output_activation
from ..ops.freq_unfold import reflect_unfold_indices
from ..ops.gsu_kernels import (
    gsu_sections_eval, gsu_stack_eval, monolith_dft_matrices, pack_stack, sfsb_monolith_serve)


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


def norm_mode(cfg) -> str:
    """The sub-band input scaling: "ln" (pre-LN), "cum", "off" or "raw"."""
    if cfg.use_pre_layer_norm_sb:
        return "ln"
    return {"cumulative_laplace_norm": "cum", "offline_laplace_norm": "off"}.get(
        cfg.norm_type, "raw")


def monolith_ok(cfg) -> bool:
    """The JAX package's gate of the monolith dispatch
    (``stream_forward.py:744-755``) without its ``Tp >= T + 3`` clause:
    that clause is TPU padding, and the port runs exactly T + 3 steps."""
    mode = norm_mode(cfg)
    return (mode in ("ln", "cum", "raw")
            and cfg.fdrc == 0.5
            and cfg.win_length == cfg.n_fft
            and cfg.n_fft == 4 * cfg.hop_length
            and (mode == "ln") == bool(cfg.use_pre_layer_norm_fb)
            and not cfg.fb_output_activate_function)


def _check_covered(cfg) -> None:
    if not stream_supported(cfg):
        raise ValueError("stream forward: unsupported config (see stream_supported)")
    if cfg.collect_layer_outputs:
        raise NotImplementedError(
            "collect_layer_outputs=True (per-layer spike tensors for synops) is not "
            "ported yet (ROADMAP queue 2: the collect path, kernel A's 4-D form)")
    if norm_mode(cfg) != "off" and not monolith_ok(cfg):
        raise NotImplementedError(
            f"norm_type={cfg.norm_type!r} with pre-LN fb/sb "
            f"{cfg.use_pre_layer_norm_fb}/{cfg.use_pre_layer_norm_sb} misses the monolith "
            "(fdrc 0.5, n_fft = win = 4 hop, no fullband output activation) and needs "
            "kernel B's pre-LN and per-frame alpha/beta terms, not ported yet "
            "(ROADMAP queue 2, item 2)")


def _fold_ln(params, acc: torch.dtype):
    """Pre-LN folded into the layer-0 input weights (``_fold_ln_weights``,
    ``stream_forward.py:153-170``, at the real widths): LN(x) @ W^T ==
    rstd (x @ W') - rstd mu u + v with W' = diag(ln_w) W^T, u its column
    sums and v = ln_b @ W^T. Returns (W' [in, rows], u [rows], v [rows])."""
    w_t = params["stack"]["layers"][0]["weight_ih"].T.to(acc)
    if "pre_ln" not in params:
        return w_t, None, None
    w_fold = params["pre_ln"]["weight"].to(acc)[:, None] * w_t
    return w_fold, w_fold.sum(dim=0), params["pre_ln"]["bias"].to(acc) @ w_t


def _section_specs(cfg, sb_params, sb_states, io: torch.dtype, acc: torch.dtype):
    """Kernel-B section dicts plus the statistics selectors.

    Returns (secs, sel_mag [F, U], sel_fb [fb_proj, U], unit_groups) where
    unit_groups lists (u0, n, w_tot) per section. With pre-LN each section
    also carries its folded ``uv`` [2, G] (acc type)."""
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
        idx_noisy = reflect_unfold_indices(lo, hi, ctr, nbr, full_f)  # [n, w_noisy]
        idx_fb = reflect_unfold_indices(
            lo, hi, cfg.fb_ctrs[i], cfg.fb_nbrs[i], full_f) % cfg.fb_proj_size
        a, b = int(idx_noisy.min()), int(idx_noisy.max()) + 1
        oh_n = torch.as_tensor(_one_hot_scatter(idx_noisy - a, b - a), dtype=acc, device=dev)
        oh_f = torch.as_tensor(_one_hot_scatter(idx_fb, cfg.fb_proj_size), dtype=acc, device=dev)

        p = sb_params[i]
        w_t0, u_ln, v_ln = _fold_ln(p, acc)  # [w_tot, G]
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
        if u_ln is not None:
            secs[-1]["uv"] = torch.stack([u_ln, v_ln]).contiguous()
        sel_cols_m.append(_one_hot_scatter(idx_noisy, full_f).sum(axis=1).T)  # [F, n]
        sel_cols_f.append(oh_f.sum(dim=1).T)  # [fb_proj, n]
        groups.append((u0, n, w_tot))
        u0 += n
    sel_mag = torch.as_tensor(np.concatenate(sel_cols_m, axis=1), dtype=acc, device=dev)
    return secs, sel_mag, torch.cat(sel_cols_f, dim=1), groups


def monolith_spec(cfg, fb_params, sb_params, state, compute: torch.dtype, acc: torch.dtype,
                  t_real: int) -> Dict[str, Any]:
    """Kernel C's spec (``ops/gsu_kernels.py``, "kernel C") from weights
    already cast to ``compute``: the statistics columns of
    ``_serve_monolith`` (``stream_forward.py:275-288``) at the real widths,
    each unit's column scaled by 1/w_tot and column U the fullband input's
    own mean, and the LN-folded fullband and section weights."""
    mode = norm_mode(cfg)
    dev = fb_params["proj"]["weight"].device
    secs, sel_mag_u, sel_fb_u, groups = _section_specs(cfg, sb_params, state["sb"], compute, acc)
    U = sum(n for _, n, _ in groups)
    sel_mag = sel_fb = None
    if mode != "raw":
        inv_w = torch.cat([torch.full((n,), 1.0 / w_tot, dtype=acc, device=dev)
                           for _, n, w_tot in groups])
        sel_mag = torch.zeros(cfg.num_freqs, U + 1, dtype=acc, device=dev)
        sel_mag[:, :U] = sel_mag_u * inv_w
        sel_mag[:cfg.fb_input_size, U] = 1.0 / cfg.fb_input_size
        sel_fb = torch.zeros(cfg.fb_proj_size, U + 1, dtype=acc, device=dev)
        sel_fb[:, :U] = sel_fb_u * inv_w
    w_fb, u_fb, v_fb = _fold_ln(fb_params, acc)
    wihr, whh, coef = pack_stack(fb_params["stack"]["layers"], state["fb"]["stack"]["layers"],
                                 cfg.fb_hidden_size, compute)
    fb = {"wa": w_fb.to(compute).contiguous(), "wihr": wihr, "whh": whh, "coef": coef,
          "wproj": fb_params["proj"]["weight"].T.to(compute).contiguous(),
          "bproj": fb_params["proj"]["bias"].to(acc).contiguous(),
          "hidden": cfg.fb_hidden_size}
    if mode == "ln":
        fb["uv"] = torch.stack([u_fb, v_fb]).contiguous()
    wdft, widft = monolith_dft_matrices(cfg.n_fft, compute, dev)
    return {"norm": mode, "n_fft": cfg.n_fft, "hop": cfg.hop_length, "eps": EPSILON,
            "t_real": t_real, "wdft": wdft, "widft": widft, "sel_mag": sel_mag,
            "sel_fb": sel_fb, "fb": fb, "secs": secs, "hidden": cfg.sb_hidden_size,
            "shared": cfg.shared_weights}


def _cola_edges(cfg, T: int, seq_len: int):
    """The monolith's COLA corrections (``stream_forward.py:328-359``), as
    (nfix, start factors, j_lo, end factors) over the trimmed output: the
    inverse DFT folds the constant 3/2, which the first n_fft - hop samples
    of the padded timeline and the last ones of the reference's T frames do
    not reach."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    half, edge = n_fft // 2, n_fft - hop
    w2 = np.square(0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)))
    env = np.zeros(edge + n_fft)
    for k in range(4):
        env[k * hop:k * hop + n_fft] += w2
    nfix = min(edge - half, seq_len)
    fix = 1.5 / np.maximum(env[half:half + max(nfix, 0)], 1e-11)
    j_lo = max(n_fft + hop * (T - 1) - edge - half, nfix)
    ps = np.arange(half + j_lo, half + seq_len)
    env_e = np.zeros(len(ps))
    for k in range(max(T - 4, 0), T):
        off = ps - k * hop
        msk = (off >= 0) & (off < n_fft)
        env_e[msk] += w2[off[msk]]
    return nfix, fix, j_lo, 1.5 / np.maximum(env_e, 1e-11)


def _serve_monolith(cfg, params, state, noisy_y: torch.Tensor, compute: torch.dtype,
                    acc: torch.dtype) -> Dict[str, Any]:
    """Whole-model serving through kernel C (``_serve_monolith``,
    ``stream_forward.py:259-366``). ``enhanced_mag`` is not materialized on
    this path, as in the JAX package."""
    B, seq_len = noisy_y.shape
    mixed = cfg.compute_dtype is not None
    fb_params = cast_floating(params["fb"], compute) if mixed else params["fb"]
    sb_params = [cast_floating(p, compute) if mixed else p for p in params["sb"]]
    hop, half = cfg.hop_length, cfg.n_fft // 2
    T = num_frames(seq_len, cfg.n_fft, hop)
    S = T + 3  # the tail frames cover the COLA end edge
    mono = monolith_spec(cfg, fb_params, sb_params, state, compute, acc, T)
    need = (S + 3) * hop
    y_pad = F.pad(noisy_y, (half, max(need - half - seq_len, 0)))[:, :need]
    chunks = y_pad.reshape(B, S + 3, hop).transpose(0, 1).to(compute).contiguous()
    out = sfsb_monolith_serve(mono, chunks)  # [S, B, hop]
    enhanced = out.transpose(0, 1).reshape(B, S * hop)[:, half:half + seq_len].clone()
    nfix, fix, j_lo, fix_e = _cola_edges(cfg, T, seq_len)
    if nfix > 0:
        enhanced[:, :nfix] *= torch.as_tensor(fix, dtype=enhanced.dtype, device=enhanced.device)
    if j_lo < seq_len:
        enhanced[:, j_lo:] *= torch.as_tensor(fix_e, dtype=enhanced.dtype,
                                              device=enhanced.device)
    return {
        "enhanced_y": enhanced,
        "enhanced_mag": None,  # not materialized on the monolith path
        "fb_all_layer_outputs": [],
        "sb_all_layer_outputs": [],
        "state": state,
    }


@torch.no_grad()
def spiking_fullsubnet_stream_forward(cfg, params, state, noisy_y: torch.Tensor):
    """Eval forward in stream layout; same output dict as the JAX package
    (``enhanced_y [B, T]``, ``enhanced_mag [B, F+1, T]`` on the two-launch
    path and None on the monolith, empty per-layer output lists, ``state``
    unchanged)."""
    _check_covered(cfg)
    if noisy_y.ndim != 2:
        raise ValueError(f"Input tensor must be 2D, but got {noisy_y.ndim}D.")
    B, sequence_length = noisy_y.shape
    mixed = cfg.compute_dtype is not None
    compute = getattr(torch, cfg.compute_dtype) if mixed else noisy_y.dtype
    acc = torch.float32 if mixed else noisy_y.dtype
    if norm_mode(cfg) != "off":
        return _serve_monolith(cfg, params, state, noisy_y, compute, acc)
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
