"""Plain PyTorch reference of Spiking-FullSubNet's eval forward, written from
the model's equations.

It imports nothing of the program under test and takes nothing that the
program made: the benchmark hands it the same audio and the same weight tree
it hands the program, and it works everything else out itself. Every product
goes through ``Ops.mm``, so the control runs this same code with its operands
rounded to a lower precision (``Ops(quant=...)``). Callers keep TF32 off.

The model (arXiv 2410.04785; github.com/haoxiangsnr/spiking-fullsubnet):
STFT (periodic Hann, centred with zeros), |X|^fdrc without the Nyquist bin,
an optional per-utterance Laplace norm, the fullband GSU stack on the lowest
bins, its output tiled over the bins, three sections of overlapping sub-band
units (reflect-padded at the spectrum's edges) each through its own GSU
stack and projection to deep-filter coefficients, the deep filter, the
Nyquist bin passed through, and the inverse STFT.

GSU cell, per step t and row (no recurrent bias):
    gates = x_t W_ih^T + h W_hh^T;  f = sigmoid(gates_f + b_f)
    c = f c + (1 - f) (gates_c + b_c);  c = BN(c);  h = (c >= 0)
With shared weights both halves read the same H gate columns. BN folds the
running statistics (eval); the carried membrane is the normalised one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
LN_EPS = 1e-5
NORM_EPS = float(np.finfo(np.float64).eps)


def geometry(factory: str, args: Dict[str, Any]) -> Dict[str, Any]:
    """The model's shapes from a configuration's ``factory`` and ``model_args``:
    ``build`` takes the unified arguments, ``build_separator`` the frozen
    competition ``Separator``'s (fullband groups per section, no pre-LN)."""
    if factory == "build":
        ctr = tuple(args["center_freq_sizes"])
        return {
            "n_fft": args["n_fft"], "hop": args["hop_length"], "win": args["win_length"],
            "fdrc": args["fdrc"], "fb_in": args["fb_input_size"], "fb_H": args["fb_hidden_size"],
            "fb_L": args["fb_num_layers"], "fb_P": args["fb_proj_size"],
            "sb_H": args["sb_hidden_size"], "sb_L": args["sb_num_layers"],
            "cutoffs": tuple(args["freq_cutoffs"]), "df": tuple(args["df_orders"]),
            "ctr": ctr, "nbr": tuple(args["neighbor_freq_sizes"]),
            "fb_ctr": tuple(args.get("fb_center_freq_sizes") or ctr),
            "fb_nbr": tuple(args.get("fb_neighbor_freq_sizes") or (0,) * len(ctr)),
            "pre_ln_fb": args["use_pre_layer_norm_fb"], "pre_ln_sb": args["use_pre_layer_norm_sb"],
            "norm": args.get("norm_type"), "bn": args["bn"], "shared": args["shared_weights"],
            "spks": args.get("num_spks", 1),
        }
    if factory == "build_separator":
        return {
            "n_fft": args["n_fft"], "hop": args["hop_length"], "win": args["win_length"],
            "fdrc": args["fdrc"], "fb_in": args["fb_freqs"], "fb_H": args["fb_hidden_size"],
            "fb_L": 2, "fb_P": args["fb_freqs"], "sb_H": args["sb_hidden_size"], "sb_L": 2,
            "cutoffs": (0, *args["freq_cutoffs"], args["num_freqs"]),
            "df": tuple(args["sb_df_orders"]), "ctr": tuple(args["sb_num_center_freqs"]),
            "nbr": tuple(args["sb_num_neighbor_freqs"]),
            "fb_ctr": tuple(args["fb_num_center_freqs"]),
            "fb_nbr": tuple(args["fb_num_neighbor_freqs"]),
            "pre_ln_fb": False, "pre_ln_sb": False, "norm": args.get("norm_type"),
            "bn": args["bn"], "shared": args["shared_weights"], "spks": 1,
        }
    raise ValueError(f"unknown factory {factory!r}")


def sections(g: Dict[str, Any]) -> List[Dict[str, int]]:
    """Per section: its bins, units, unit widths, stack input and projection."""
    out = []
    for i in range(len(g["ctr"])):
        lo, hi = g["cutoffs"][i], g["cutoffs"][i + 1]
        ctr, nbr, fctr, fnbr = g["ctr"][i], g["nbr"][i], g["fb_ctr"][i], g["fb_nbr"][i]
        out.append({"lo": lo, "hi": hi, "units": (hi - lo) // ctr, "ctr": ctr, "nbr": nbr,
                    "fb_ctr": fctr, "fb_nbr": fnbr, "df": g["df"][i],
                    "in": (ctr + 2 * nbr) + (fctr + 2 * fnbr),
                    "proj": 2 * ctr * g["df"][i] * g["spks"]})
    return out


class Ops:
    """The arithmetic the control changes: ``quant`` rounds both operands of
    every product to a lower precision and back, and the product runs in
    float32 as before: "tf32" (10 mantissa bits, to nearest even, as the
    tensor cores take float32 operands) or a torch type such as "bfloat16"."""

    def __init__(self, quant: Optional[str] = None):
        self.quant = quant

    def round(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant is None:
            return x
        if self.quant == "tf32":
            i = x.float().view(torch.int32)
            i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
            return i.view(torch.float32).to(x.dtype)
        return x.to(getattr(torch, self.quant)).to(x.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)


PLAIN = Ops()


# ---------------------------------------------------------------- pieces


def stft(y: torch.Tensor, n_fft: int, hop: int, win: int, pad_mode: str = "constant"):
    window = torch.hann_window(win, periodic=True, dtype=y.dtype, device=y.device)
    return torch.stft(y, n_fft, hop, win, window=window, center=True, pad_mode=pad_mode,
                      return_complex=True)


def istft(spec: torch.Tensor, n_fft: int, hop: int, win: int, length: int) -> torch.Tensor:
    window = torch.hann_window(win, periodic=True, dtype=spec.real.dtype, device=spec.device)
    return torch.istft(spec, n_fft, hop, win, window=window, center=True, length=length)


def laplace_norm(x: torch.Tensor) -> torch.Tensor:
    """Divide by the utterance's mean over every axis but the first."""
    return x / (x.mean(dim=tuple(range(1, x.ndim)), keepdim=True) + NORM_EPS)


def unfold_index(lo: int, hi: int, ctr: int, nbr: int, num_freqs: int) -> torch.Tensor:
    """Bins read by each unit, ``[units, ctr + 2 nbr]``, reflected at 0 and
    at ``num_freqs - 1``."""
    n = (hi - lo) // ctr
    pos = lo - nbr + torch.arange(n)[:, None] * ctr + torch.arange(ctr + 2 * nbr)[None, :]
    pos = pos.abs()
    over = pos - (num_freqs - 1)
    return torch.where(over > 0, (num_freqs - 1) - over, pos)


def layer_norm(p, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * p["weight"] + p["bias"]


def gsu_layer(p, st, x: torch.Tensor, H: int, shared: bool, ops: Ops) -> torch.Tensor:
    """One GSU layer over ``x [T, R, F]`` -> spikes ``[T, R, H]``."""
    T, R, _ = x.shape
    xg = ops.mm(x.reshape(T * R, -1), p["weight_ih"].T).reshape(T, R, -1)
    whh_t = p["weight_hh"].T
    b_f, b_c = p["bias_ih"][:H], p["bias_ih"][H:]
    bn = p.get("bn")
    if bn is not None:
        rv, rm = st["bn"]["running_var"], st["bn"]["running_mean"]
        scale = bn["weight"] * torch.rsqrt(rv + BN_EPS)
        shift = bn["bias"] - rm * scale
    h = x.new_zeros(R, H)
    c = x.new_zeros(R, H)
    out = []
    for t in range(T):
        gates = xg[t] + ops.mm(h, whh_t)
        if shared:
            f_in, c_in = gates + b_f, gates + b_c
        else:
            f_in, c_in = gates[:, :H] + b_f, gates[:, H:] + b_c
        f = torch.sigmoid(f_in)
        c = f * c + (1.0 - f) * c_in
        if bn is not None:
            c = c * scale + shift
        h = (c >= 0).to(c.dtype)
        out.append(h)
    return torch.stack(out)


def sequence_model(p, st, x: torch.Tensor, H: int, shared: bool, pre_ln: bool,
                   ops: Ops) -> torch.Tensor:
    """``x [R, F, T]`` -> projection ``[R, P, T]``."""
    xt = x.permute(2, 0, 1)
    if pre_ln:
        xt = layer_norm(p["pre_ln"], xt)
    for lp, ls in zip(p["stack"]["layers"], st["stack"]["layers"]):
        xt = gsu_layer(lp, ls, xt, H, shared, ops)
    T, R, _ = xt.shape
    proj = ops.mm(xt.reshape(T * R, H), p["proj"]["weight"].T) + p["proj"]["bias"]
    return proj.reshape(T, R, -1).permute(1, 2, 0)


def forward(g: Dict[str, Any], params, state, noisy: torch.Tensor,
            ops: Ops = PLAIN) -> torch.Tensor:
    """``noisy [B, N]`` -> enhanced ``[B, N]``, with BN's running statistics
    folded in (eval)."""
    B, N = noisy.shape
    nf = g["n_fft"] // 2
    spec = stft(noisy, g["n_fft"], g["hop"], g["win"])  # [B, nf + 1, T]
    T = spec.shape[-1]
    mag = (spec.abs() ** g["fdrc"])[:, :nf]  # [B, nf, T]
    fb_in = mag[:, :g["fb_in"]]
    if g["norm"] == "offline_laplace_norm":
        fb_in = laplace_norm(fb_in)
    elif g["norm"] is not None:
        raise NotImplementedError(f"norm {g['norm']!r}")
    fb_out = sequence_model(params["fb"], state["fb"], fb_in, g["fb_H"], g["shared"],
                            g["pre_ln_fb"], ops)
    reps = (nf + 1) // g["fb_in"]
    tile = fb_out.repeat(1, reps, 1)  # [B, P reps, T]
    enh = []
    for i, s in enumerate(sections(g)):
        idx_m = unfold_index(s["lo"], s["hi"], s["ctr"], s["nbr"], nf).to(noisy.device)
        idx_f = unfold_index(s["lo"], s["hi"], s["fb_ctr"], s["fb_nbr"], tile.shape[1])
        idx_f = idx_f.clamp(max=tile.shape[1] - 1).to(noisy.device)
        x = torch.cat([mag[:, idx_m], tile[:, idx_f]], dim=2)  # [B, U, w, T]
        if g["norm"] == "offline_laplace_norm":
            x = laplace_norm(x)
        U = s["units"]
        proj = sequence_model(params["sb"][i], state["sb"][i], x.reshape(B * U, -1, T),
                              g["sb_H"], g["shared"], g["pre_ln_sb"], ops)
        # projection columns (re/im, centre bin, tap, speaker), speaker 0
        coef = proj.reshape(B, U, 2, s["ctr"], s["df"], g["spks"], T)[:, :, :, :, :, 0]
        coef = coef.permute(0, 4, 1, 3, 5, 2).reshape(B, s["df"], U * s["ctr"], T, 2)
        band = spec[:, s["lo"]:s["hi"]]
        padded = F.pad(band, (s["df"] - 1, 0))
        acc = 0
        for d in range(s["df"]):
            acc = acc + padded[..., d:d + T] * torch.complex(coef[:, d, ..., 0].to(band.real.dtype),
                                                             coef[:, d, ..., 1].to(band.real.dtype))
        enh.append(acc)
    enh.append(spec[:, nf:])
    return istft(torch.cat(enh, dim=1), g["n_fft"], g["hop"], g["win"], N)
