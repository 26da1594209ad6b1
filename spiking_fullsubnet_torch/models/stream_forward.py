"""Stream forward, eval and training (counterpart of
``spiking_fullsubnet_tpu/models/stream_forward.py``). Three paths, as the
JAX package dispatches them (``stream_forward.py:519-523`` and ``:734-759``):

**Monolith** (eval without collecting the per-layer outputs; norms "ln" =
pre-LayerNorm, "cum" = cumulative laplace norm, "raw" = none, when the
config passes the monolith's gate ``monolith_ok``; the flagship preset):
the audio is left-padded by n_fft/2 and cut into hop chunks, and **kernel
C** (``ops/gsu_kernels.sfsb_monolith_serve``) runs the whole model per
step: windowed DFT, ``|X|^0.5``, the norm statistics, the fullband stack
and projection, every unit's layer-0 gates, the section stacks, projection
and deep filter, the inverse DFT and the overlap-add. Here around it: the
LN fold into the layer-0 weights (``_fold_ln``), the one-hot scatter of
each unit's unfold into its weights, the statistics columns, the chunking,
the trim and the COLA start- and end-edge corrections.

**Two-launch** (eval without collecting, every other config: the offline
laplace norm of the zoo checkpoints, and the "ln"/"cum"/"raw" configs that
miss the monolith's gate; time-major ``[T, B, ...]`` from the STFT to the
iSTFT; ``_serve_two_launch``):

1. STFT as a windowed-DFT matmul (``dsp/spectral.py``), ``mag = |X|^fdrc``
   without the Nyquist bin;
2. the fullband input norm (offline or cumulative laplace norm, pre-LN or
   none), the hoisted layer-0 fullband matmul, **kernel A**
   (``ops/gsu_kernels.gsu_stack_eval``) for the fullband stack, and the
   fullband projection;
3. the merged sub-band build: each unit's frequency unfold (reflect padding
   and the fullband tile included) is folded into one-hot scattered layer-0
   weights over a window of the magnitude and over the fullband output (with
   pre-LN folded in, ``alpha ck - beta u + v``), and the projection's
   columns are permuted to (c, d, fc) order so that every deep-filter tap is
   a contiguous slice;
4. one statistics sweep gives every unit's scale (``_unit_scales``: one
   per utterance and unit for the offline norm, per frame for the others,
   none without a norm), then **kernel B** (``ops/gsu_kernels.
   gsu_sections_eval``) runs all sections, their projection and the deep
   filter;
5. the Nyquist bin passes through and the iSTFT gives the audio.

**Per section** (``_sectioned``: eval with ``collect_layer_outputs=True``,
and every training step; the merged kernels need ``not train and not
collect``, ``stream_forward.py:519-523``, so neither B nor C runs): the
same time-major glue. The fullband stack on kernel A with every layer
collected (eval) or on kernels D and E (training: ``ops/gsu.
gsu_stack_train_xg``, one ``GSULayerTrain`` a layer, the inter-layer
products as matmuls), its projection; then per section each unit's layer-0
gates ``alpha ck - beta u + v`` from one-hot scattered weights
(``_section_gates``: the LN fold for pre-LN, alpha and beta from the
section's norm), the section's stack on kernel A's units form ``[n, T, B,
G]`` with every layer collected (eval) or, with the units folded into rows
unit-major ``[T, n B, G]``, on D and E (training), the projection with its
columns in (c, d, fc) order and the deep filter; the Nyquist passthrough,
the iSTFT, the synops lists of the JAX package (``:706-732``, ``:841-845``:
fullband ``[normed input, spikes..., projection]``, each section ``[normed
unfolded input, spikes..., projection]`` with ``(b n)`` rows) when
collecting, and in training the new BN running statistics. Training is
differentiable end to end in autograd; the kernels' streams are the compute
type, bfloat16 under the bf16 policy (``gsu_layer_pallas_train_padded``'s
io), membranes float32.

The TPU layout padding of the JAX package (``Tp = round_up(T, 128)``,
128-lane gate, projection and spectrum widths, 128-aligned windows, batch
rows padded to 8) is gone: the port runs at the real T (the monolith runs
exactly T + 3 steps), H, G and window widths. Every config that
``stream_supported`` takes runs, in eval and in training.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.mask import EPSILON
from ..dsp.spectral import istft_real_imag_tmajor, num_frames, stft_real_imag_tmajor
from ..nn.core import cast_floating, layer_norm_apply, output_activation
from ..ops.freq_unfold import reflect_unfold_indices
from ..ops.gsu import gsu_stack_train_xg
from ..ops.gsu_kernels import (
    gsu_sections_eval, gsu_stack_eval, monolith_dft_matrices, pack_stack, sfsb_monolith_serve)

LN_EPS = 1e-5


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


def _section_geometry(cfg, i: int) -> Dict[str, Any]:
    """Section i's units and their frequency unfold as one-hot maps
    (``stream_forward.py:541-556``): ``n`` units of ``ctr`` centre bins and
    deep-filter order ``df``; ``w_noisy`` lanes of the noisy magnitude and
    ``w_tot`` in all a unit; ``idx_noisy [n, w_noisy]`` their source bins
    (reflect padding included), ``a`` the first bin of the section's window
    ``[a, b)``; ``oh_n [n, w_noisy, b - a]`` and ``oh_f [n, w_fb, fb_proj]``
    (the fullband tile folded back onto the projection lanes), with
    ``idx_fb [n, w_fb]`` its source lanes, numpy."""
    lo, hi = cfg.freq_cutoffs[i], cfg.freq_cutoffs[i + 1]
    ctr, nbr = cfg.center_freq_sizes[i], cfg.neighbor_freq_sizes[i]
    w_noisy = ctr + 2 * nbr
    idx_noisy = reflect_unfold_indices(lo, hi, ctr, nbr, cfg.num_freqs)  # [n, w_noisy]
    idx_fb = reflect_unfold_indices(
        lo, hi, cfg.fb_ctrs[i], cfg.fb_nbrs[i], cfg.num_freqs) % cfg.fb_proj_size
    a, b = int(idx_noisy.min()), int(idx_noisy.max()) + 1
    return {"n": (hi - lo) // ctr, "ctr": ctr, "df": cfg.df_orders[i], "w_noisy": w_noisy,
            "w_tot": w_noisy + cfg.fb_ctrs[i] + 2 * cfg.fb_nbrs[i], "idx_noisy": idx_noisy,
            "idx_fb": idx_fb, "a": a, "b": b, "oh_n": _one_hot_scatter(idx_noisy - a, b - a),
            "oh_f": _one_hot_scatter(idx_fb, cfg.fb_proj_size)}


def _df_column_order(ctr: int, df: int) -> np.ndarray:
    """The projection's columns from the reference's (c, fc, d) order to
    (c, d, fc), so that each deep-filter tap is a contiguous slice:
    ``new[(c df + d) ctr + fc] = old[(c ctr + fc) df + d]``."""
    return (np.arange(2)[:, None, None] * ctr * df
            + np.arange(ctr)[None, None, :] * df
            + np.arange(df)[None, :, None]).reshape(-1)


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
        g = _section_geometry(cfg, i)
        n, w_noisy = g["n"], g["w_noisy"]
        oh_n = torch.as_tensor(g["oh_n"], dtype=acc, device=dev)
        oh_f = torch.as_tensor(g["oh_f"], dtype=acc, device=dev)

        p = sb_params[i]
        w_t0, u_ln, v_ln = _fold_ln(p, acc)  # [w_tot, G]
        # scatter[n, p, j] = sum_w onehot[n, w, p] W[w, j], rounded once to io
        wa = torch.einsum("nwp,wj->npj", oh_n, w_t0[:w_noisy]).to(io).contiguous()
        wb = torch.einsum("nwp,wj->npj", oh_f, w_t0[w_noisy:]).to(io).contiguous()
        src_t = torch.as_tensor(_df_column_order(g["ctr"], g["df"]), device=dev)
        wihr, whh, coef = pack_stack(p["stack"]["layers"], sb_states[i]["stack"]["layers"],
                                     H, io)
        secs.append({
            "wa": wa, "a0": g["a"], "wb": wb, "wihr": wihr, "whh": whh, "coef": coef,
            "wproj": p["proj"]["weight"][src_t].T.to(io).contiguous(),
            "bproj": p["proj"]["bias"][src_t].to(acc).contiguous(),
            "ctr": g["ctr"], "df": g["df"],
        })
        if u_ln is not None:
            secs[-1]["uv"] = torch.stack([u_ln, v_ln]).contiguous()
        sel_cols_m.append(_one_hot_scatter(g["idx_noisy"], full_f).sum(axis=1).T)  # [F, n]
        sel_cols_f.append(oh_f.sum(dim=1).T)  # [fb_proj, n]
        groups.append((u0, n, g["w_tot"]))
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
    fb_params, sb_params = _cast_params(cfg, params, compute)
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


def _policy(cfg, noisy_y: torch.Tensor):
    """(compute type, accumulation type, DFT matmul type) of the bf16 policy
    or of the input's own type."""
    if cfg.compute_dtype is None:
        return noisy_y.dtype, noisy_y.dtype, None
    compute = getattr(torch, cfg.compute_dtype)
    return compute, torch.float32, compute


def _cast_params(cfg, params, compute: torch.dtype):
    """(fullband, [section]) weights in the compute type under the bf16
    policy, as given otherwise."""
    if cfg.compute_dtype is None:
        return params["fb"], params["sb"]
    return cast_floating(params["fb"], compute), [cast_floating(p, compute) for p in params["sb"]]


def _magnitude(cfg, noisy_y: torch.Tensor, dft_dtype, compute: torch.dtype):
    """Time-major STFT ``(re, im) [T, B, F+1]`` and ``|X|^fdrc`` without the
    Nyquist bin ``[T, B, F]`` in the compute type."""
    re_t, im_t = stft_real_imag_tmajor(
        noisy_y, cfg.n_fft, cfg.hop_length, cfg.win_length, matmul_dtype=dft_dtype)
    re_t, im_t = re_t.contiguous(), im_t.contiguous()
    mag_t = ((re_t.square() + im_t.square()) ** (cfg.fdrc / 2))[..., :cfg.num_freqs]
    return re_t, im_t, mag_t.to(compute).contiguous()


def _fullband_gates(cfg, fb_params, mag_t: torch.Tensor, compute: torch.dtype,
                    acc: torch.dtype):
    """The fullband stack's normed input ``[T, B, Fin]`` and layer-0 gates
    ``[T, B, rows]``, both in the compute type (``stream_forward.py:
    415-442``): the input norm (the offline laplace norm, one scalar per
    utterance over the frames; the cumulative one, a running mean; pre-LN;
    or none), then the hoisted product with ``W_ih^T`` summed in the
    accumulation type."""
    T, B, _ = mag_t.shape
    fb_in = mag_t[..., :cfg.fb_input_size]
    if cfg.norm_type is not None:
        f_sum = fb_in.to(acc).sum(dim=-1)  # [T, B]
        if cfg.norm_type == "cumulative_laplace_norm":
            cnt = torch.arange(1, T + 1, dtype=acc, device=mag_t.device)[:, None]
            mu = torch.cumsum(f_sum, dim=0) / (cnt * cfg.fb_input_size)
        else:
            mu = (f_sum.sum(dim=0) / (cfg.fb_input_size * T))[None].expand(T, B)
        fb_in = (fb_in.to(acc) / (mu[..., None] + EPSILON)).to(compute)
    elif cfg.use_pre_layer_norm_fb:
        fb_in = layer_norm_apply(fb_params["pre_ln"], fb_in)
    w0 = fb_params["stack"]["layers"][0]["weight_ih"].T.to(acc)
    return fb_in, (fb_in.reshape(T * B, -1).to(acc) @ w0).reshape(T, B, -1).to(compute)


def _fullband_output(cfg, fb_params, spikes: torch.Tensor, compute: torch.dtype,
                     acc: torch.dtype):
    """The fullband projection ``[T, B, fb_proj]`` in the accumulation type
    and its output activation in the compute type (``stream_forward.py:
    458-466``)."""
    proj = (spikes.to(acc) @ fb_params["proj"]["weight"].T.to(acc)
            + fb_params["proj"]["bias"].to(acc))
    return proj, output_activation(cfg.fb_output_activate_function)(proj).to(compute)


def _unit_scales(cfg, mag_t: torch.Tensor, fb_act: torch.Tensor, sel_mag: torch.Tensor,
                 sel_fb: torch.Tensor, groups, acc: torch.dtype):
    """Kernel B's (alpha, beta) from one statistics sweep over every unit
    (``stream_forward.py:761-807``, at the real T): "off" one scale per
    utterance and section ``[B, U]``; "cum" the reciprocal running mean
    ``[T, B, U]``; "ln" ``rstd`` and ``rstd mu`` of each unit's input ``[T,
    B, U]``; "raw" none."""
    mode = norm_mode(cfg)
    if mode == "raw":
        return None, None
    T, B, _ = mag_t.shape
    mag32, fb32 = mag_t.to(acc), fb_act.to(acc)
    s1 = mag32 @ sel_mag + fb32 @ sel_fb  # [T, B, U]
    if mode == "off":
        sec_sum = s1.sum(dim=0)  # [B, U]
        return torch.cat([
            (1.0 / (sec_sum[:, u0:u0 + n].sum(dim=-1) / (n * w_tot * T) + EPSILON))[:, None]
            .expand(B, n) for u0, n, w_tot in groups], dim=1).contiguous(), None
    inv_wt = torch.cat([torch.full((n,), 1.0 / w_tot, dtype=acc, device=mag_t.device)
                        for _, n, w_tot in groups])
    if mode == "ln":
        s2 = mag32.square() @ sel_mag + fb32.square() @ sel_fb
        mu = s1 * inv_wt
        rstd = torch.rsqrt(s2 * inv_wt - mu.square() + LN_EPS)
        return rstd.contiguous(), (rstd * mu).contiguous()
    cnt = torch.arange(1, T + 1, dtype=acc, device=mag_t.device)[:, None, None]
    return (1.0 / (torch.cumsum(s1, dim=0) * inv_wt / cnt + EPSILON)).contiguous(), None


def _assemble(cfg, enh_re: List[torch.Tensor], enh_im: List[torch.Tensor], re_t, im_t,
              seq_len: int, dft_dtype):
    """The enhanced bins with the Nyquist bin passed through: (enhanced_y
    ``[B, seq_len]`` from the iSTFT, enhanced_mag ``[B, F+1, T]``)."""
    out_re = torch.cat(enh_re + [re_t[..., cfg.num_freqs:]], dim=-1)
    out_im = torch.cat(enh_im + [im_t[..., cfg.num_freqs:]], dim=-1)
    enhanced_y = istft_real_imag_tmajor(
        out_re, out_im, cfg.n_fft, cfg.hop_length, cfg.win_length,
        length=seq_len, matmul_dtype=dft_dtype)
    return enhanced_y, torch.sqrt(out_re.square() + out_im.square()).permute(1, 2, 0)


@torch.no_grad()
def _serve_two_launch(cfg, params, state, noisy_y: torch.Tensor) -> Dict[str, Any]:
    """Eval on kernels A and B, any norm (the module docstring). ``_serve``
    takes it for the offline norm and for the configs the monolith does not
    take; it runs any config ``stream_supported`` takes."""
    compute, acc, dft_dtype = _policy(cfg, noisy_y)
    H_fb, shared = cfg.fb_hidden_size, cfg.shared_weights
    re_t, im_t, mag_t = _magnitude(cfg, noisy_y, dft_dtype, compute)
    fb_params, sb_params = _cast_params(cfg, params, compute)

    # ---- fullband: input norm, hoisted layer 0, kernel A ----
    _, xg0_fb = _fullband_gates(cfg, fb_params, mag_t, compute, acc)
    wihr, whh, coef = pack_stack(fb_params["stack"]["layers"],
                                 state["fb"]["stack"]["layers"], H_fb, compute)
    fb_spikes = gsu_stack_eval(xg0_fb.contiguous(), wihr, whh, coef, H_fb, shared)
    fb_act = _fullband_output(cfg, fb_params, fb_spikes, compute, acc)[1].contiguous()

    # ---- sub-band sections: statistics sweep, kernel B ----
    secs, sel_mag, sel_fb, groups = _section_specs(cfg, sb_params, state["sb"], compute, acc)
    alpha, beta = _unit_scales(cfg, mag_t, fb_act, sel_mag, sel_fb, groups, acc)
    enh_re, enh_im = gsu_sections_eval(secs, mag_t, fb_act, alpha, re_t, im_t,
                                       cfg.sb_hidden_size, shared, beta)
    enhanced_y, enhanced_mag = _assemble(cfg, [enh_re], [enh_im], re_t, im_t,
                                         noisy_y.shape[1], dft_dtype)
    return {"enhanced_y": enhanced_y, "enhanced_mag": enhanced_mag,
            "fb_all_layer_outputs": [], "sb_all_layer_outputs": [], "state": state}


def _section_gates(cfg, i: int, p, mag_t: torch.Tensor, fb_act: torch.Tensor,
                   compute: torch.dtype, acc: torch.dtype):
    """Section i's layer-0 gates, units-major ``[n, T, B, rows]`` in the
    compute type (``stream_forward.py:527-665``), with the unit scales
    ``alpha`` and means ``mu`` ``[T, B, n]`` they came from. Each unit's
    frequency unfold (reflect padding and the fullband tile included) is
    folded into one-hot scattered layer-0 weights over a window of the
    magnitude and over the fullband output, ``ck = mag_win @ Wn_k + fb @
    Wf_k``, and the norm enters as ``xg = alpha ck - beta u + v``: "ln" the
    pre-LN fold (``_fold_ln``, its u and v) with alpha = rstd and beta =
    rstd mu of the unit's input, "cum" the reciprocal running mean, "off"
    one reciprocal mean per utterance and section, "raw" ``ck`` as it is
    (alpha None). One unit at a time, as the JAX package: the f32
    intermediates of a whole section at the serving batch would take tens of
    GB. Everything that reaches a parameter (the fold, the scattered
    weights, the fullband output in alpha) stays in autograd."""
    T, B, _ = mag_t.shape
    g = _section_geometry(cfg, i)
    n, w_noisy, w_tot, a, b = g["n"], g["w_noisy"], g["w_tot"], g["a"], g["b"]
    oh_n, oh_f = g["oh_n"], g["oh_f"]
    dev = mag_t.device
    mode = norm_mode(cfg)
    w_t0, u, v = _fold_ln(p, compute)  # [w_tot, rows]; u, v only with pre-LN
    # scatter[k, p, j] = sum_w onehot[k, w, p] W[w, j]
    wsc_n = torch.einsum("nwp,wj->npj", torch.as_tensor(oh_n, dtype=compute, device=dev),
                         w_t0[:w_noisy])
    wsc_f = torch.einsum("nwp,wj->npj", torch.as_tensor(oh_f, dtype=compute, device=dev),
                         w_t0[w_noisy:])
    mag_sec = mag_t[:, :, a:b].reshape(T * B, b - a).to(acc)
    fb32 = fb_act.reshape(T * B, -1).to(acc)
    alpha = beta = mu = None
    if mode != "raw":
        sel_n = torch.as_tensor(oh_n.sum(axis=1).T, dtype=acc, device=dev)  # [b - a, n]
        sel_f = torch.as_tensor(oh_f.sum(axis=1).T, dtype=acc, device=dev)  # [fb_proj, n]
        s1 = (mag_sec @ sel_n + fb32 @ sel_f).reshape(T, B, n)
        if mode == "ln":
            s2 = (mag_sec.square() @ sel_n + fb32.square() @ sel_f).reshape(T, B, n)
            mu = s1 / w_tot
            alpha = torch.rsqrt(s2 / w_tot - mu.square() + LN_EPS)
            beta = alpha * mu
        elif mode == "cum":
            cnt = torch.arange(1, T + 1, dtype=acc, device=dev)[:, None, None] * w_tot
            alpha = 1.0 / (torch.cumsum(s1, dim=0) / cnt + EPSILON)
        else:  # "off": one scalar per utterance over (units, window, frames)
            tot = s1.sum(dim=(0, 2)) / (n * w_tot * T)  # [B]
            alpha = (1.0 / (tot + EPSILON))[None, :, None].expand(T, B, n)
    units = []
    for k in range(n):
        # each product summed in the accumulation type, rounded to the compute type
        ck = (mag_sec @ wsc_n[k].to(acc)).to(compute) + (fb32 @ wsc_f[k].to(acc)).to(compute)
        if alpha is not None:
            xg = alpha[:, :, k].reshape(T * B, 1) * ck.to(acc)
            if beta is not None:
                xg = xg - beta[:, :, k].reshape(T * B, 1) * u.to(acc) + v.to(acc)
            ck = xg.to(compute)
        units.append(ck.reshape(T, B, -1))
    return torch.stack(units), alpha, mu


def _section_input(cfg, i: int, p, mag_t: torch.Tensor, fb_act: torch.Tensor, alpha, mu,
                   compute: torch.dtype, acc: torch.dtype) -> torch.Tensor:
    """The synops list's first entry of section i (``stream_forward.py:
    706-722``): each unit's unfolded input after the section's norm, ``[T,
    B n, w_tot]`` (rows b-major) in the compute type: the LayerNorm for "ln",
    ``x alpha`` for "cum" and "off", the input as it is for "raw"."""
    T, B, _ = mag_t.shape
    g = _section_geometry(cfg, i)
    dev = mag_t.device
    x = torch.cat([mag_t[:, :, torch.as_tensor(g["idx_noisy"], device=dev)],
                   fb_act[:, :, torch.as_tensor(g["idx_fb"], device=dev)]], dim=-1).to(acc)
    if mu is not None:
        x = (x - mu[..., None]) * alpha[..., None]
        x = x * p["pre_ln"]["weight"].to(acc) + p["pre_ln"]["bias"].to(acc)
    elif alpha is not None:
        x = x * alpha[..., None]
    return x.to(compute).reshape(T, B * g["n"], g["w_tot"])


def _section_proj(cfg, i: int, p, spikes: torch.Tensor, compute: torch.dtype,
                  acc: torch.dtype) -> torch.Tensor:
    """Section i's projection of its last layer's spikes ``[n, T, B, H]``
    -> ``[n, T, B, P]`` in the compute type, the columns permuted from the
    reference's (c, fc, d) order to (c, d, fc) (``stream_forward.py:
    586-590``, ``:691-696``)."""
    src_t = torch.as_tensor(_df_column_order(cfg.center_freq_sizes[i], cfg.df_orders[i]),
                            device=spikes.device)
    w_proj, b_proj = p["proj"]["weight"][src_t], p["proj"]["bias"][src_t]
    proj = (spikes.to(acc) @ w_proj.T.to(acc)).to(compute) + b_proj.to(compute)
    return output_activation(cfg.sb_config(i).output_activate_function)(proj)


def _deep_filter_tmajor(proj: torch.Tensor, ctr: int, df: int, sre: torch.Tensor,
                        sim: torch.Tensor, acc: torch.dtype):
    """The complex deep filter in real arithmetic (``_df_section``,
    ``stream_forward.py:475-512``): a section's projection ``[n, T, B, 2 df
    ctr]`` in (c, d, fc) order, the units laid beside each other within each
    tap, against the noisy spectrum's bins ``sre, sim [T, B, n ctr]``; tap d
    weighs frame t - df + 1 + d. Returns the enhanced ``(re, im) [T, B, n
    ctr]``."""
    n, T, B = proj.shape[:3]
    coef = proj.reshape(n, T, B, 2, df, ctr).permute(1, 2, 3, 4, 0, 5).reshape(
        T, B, 2, df, n * ctr)
    pad = (0, 0, 0, 0, df - 1, 0)
    pr, pi = F.pad(sre, pad), F.pad(sim, pad)
    er = ei = None
    for d in range(df):
        tr, ti = pr[d:d + T], pi[d:d + T]
        cr, ci = coef[:, :, 0, d].to(acc), coef[:, :, 1, d].to(acc)
        t_re, t_im = tr * cr - ti * ci, tr * ci + ti * cr
        er = t_re if er is None else er + t_re
        ei = t_im if ei is None else ei + t_im
    return er, ei


def _sectioned(cfg, params, state, noisy_y: torch.Tensor, train: bool) -> Dict[str, Any]:
    """The per-section stream forward (``stream_forward.py:368-870`` on its
    train and collecting branches, at the real T and widths): eval with the
    GSU stacks on kernel A, every layer collected, or training with them on
    kernels D and E and the new BN running statistics in ``state`` (the
    state as given without BN, and in eval). The synops lists when
    ``collect_layer_outputs``, else empty."""
    B, seq_len = noisy_y.shape
    compute, acc, dft_dtype = _policy(cfg, noisy_y)
    collect, shared = cfg.collect_layer_outputs, cfg.shared_weights
    re_t, im_t, mag_t = _magnitude(cfg, noisy_y, dft_dtype, compute)
    fb_params, sb_params = _cast_params(cfg, params, compute)
    T = mag_t.shape[0]

    def stack(p, st, xg0, hidden):
        """Every layer's spikes ``[(n,) T, B, H]`` and the new stack state
        from layer 0's gates ``[(n,) T, B, G]``."""
        if not train:
            w = pack_stack(p["stack"]["layers"], st["stack"]["layers"], hidden, compute)
            out = gsu_stack_eval(xg0.contiguous(), *w, hidden, shared, collect_all=collect)
            return (list(out) if collect else [out]), st
        if xg0.ndim == 3:
            spikes, new = gsu_stack_train_xg(p["stack"], st["stack"], xg0, hidden, shared)
            return spikes, {"stack": new}
        # units fold into rows unit-major, so that BN's statistics span them all
        n = xg0.shape[0]
        spikes, new = gsu_stack_train_xg(p["stack"], st["stack"],
                                         xg0.transpose(0, 1).reshape(T, n * B, -1), hidden,
                                         shared)
        return [s.reshape(T, n, B, hidden).transpose(0, 1) for s in spikes], {"stack": new}

    fb_in, xg0_fb = _fullband_gates(cfg, fb_params, mag_t, compute, acc)
    fb_spikes, new_fb = stack(fb_params, state["fb"], xg0_fb, cfg.fb_hidden_size)
    fb_proj, fb_act = _fullband_output(cfg, fb_params, fb_spikes[-1], compute, acc)

    enh_re: List[torch.Tensor] = []
    enh_im: List[torch.Tensor] = []
    new_sb, sb_lists = [], []
    f0 = 0
    for i in range(cfg.num_sections):
        p = sb_params[i]
        ctr, df = cfg.center_freq_sizes[i], cfg.df_orders[i]
        xg0, alpha, mu = _section_gates(cfg, i, p, mag_t, fb_act, compute, acc)
        n = xg0.shape[0]
        spikes, ns = stack(p, state["sb"][i], xg0, cfg.sb_hidden_size)
        del xg0
        new_sb.append(ns)
        proj = _section_proj(cfg, i, p, spikes[-1], compute, acc)
        w = n * ctr
        er, ei = _deep_filter_tmajor(proj, ctr, df, re_t[:, :, f0:f0 + w],
                                     im_t[:, :, f0:f0 + w], acc)
        enh_re.append(er)
        enh_im.append(ei)
        f0 += w
        if collect:
            # the contract's rows are b-major (t (b n) feat), the projection's
            # columns in the reference's order
            to_bn = lambda x: x.permute(1, 2, 0, 3).reshape(T, B * n, x.shape[-1])  # noqa: E731
            inv = torch.as_tensor(np.argsort(_df_column_order(ctr, df)), device=proj.device)
            sb_lists.append(
                [_section_input(cfg, i, p, mag_t, fb_act, alpha, mu, compute, acc)]
                + [to_bn(s) for s in spikes] + [to_bn(proj)[..., inv].to(acc)])
        del spikes, proj

    enhanced_y, enhanced_mag = _assemble(cfg, enh_re, enh_im, re_t, im_t, seq_len, dft_dtype)
    new_state = state
    if train and cfg.bn:
        new_state = {"fb": new_fb, "sb": new_sb}
    return {
        "enhanced_y": enhanced_y,
        "enhanced_mag": enhanced_mag,
        "fb_all_layer_outputs": [fb_in, *fb_spikes, fb_proj] if collect else [],
        "sb_all_layer_outputs": sb_lists,
        "state": new_state,
    }


def spiking_fullsubnet_stream_forward(cfg, params, state, noisy_y: torch.Tensor,
                                      train: bool = False):
    """Forward in stream layout; same output dict as the JAX package
    (``enhanced_y [B, T]``, ``enhanced_mag [B, F+1, T]``, None on the
    monolith, the per-layer output lists when collecting, else empty). Eval
    runs without autograd and returns ``state`` unchanged; ``train=True``
    runs the per-section path in autograd."""
    if not stream_supported(cfg):
        raise ValueError("stream forward: unsupported config (see stream_supported)")
    if noisy_y.ndim != 2:
        raise ValueError(f"Input tensor must be 2D, but got {noisy_y.ndim}D.")
    if train:
        return _sectioned(cfg, params, state, noisy_y, train=True)
    return _serve(cfg, params, state, noisy_y)


@torch.no_grad()
def _serve(cfg, params, state, noisy_y: torch.Tensor) -> Dict[str, Any]:
    """Eval, dispatched as the JAX package: the per-section path when
    collecting the per-layer outputs, else the monolith where its gate
    admits the config, else the two-launch path."""
    if cfg.collect_layer_outputs:
        return _sectioned(cfg, params, state, noisy_y, train=False)
    if monolith_ok(cfg):
        compute, acc, _ = _policy(cfg, noisy_y)
        return _serve_monolith(cfg, params, state, noisy_y, compute, acc)
    return _serve_two_launch(cfg, params, state, noisy_y)
