"""Witnesses for two faults of zoo M's stream-train step with bf16 streams on
the card (``baseline_m.npz``, ``chip_smoke.py``'s training batch of 64 x 6
s, ``scan_mode="stream"``, ``compute_dtype="bfloat16"``).

1. determinism: two forwards and backwards of the same step from the same
   weights, every launch of kernels D and E recorded with its inputs and
   outputs; the first launch whose inputs differ between the two runs
   names the place where the backward stops being deterministic. Beside
   it: each recorded launch of D and E run again on its own inputs, the
   loss's gradient taken twice from one graph, torch.stft's reflect-padded
   gradient against the port's ``stft_complex``, and the operations that
   ``torch.use_deterministic_algorithms(True, warn_only=True)`` names.
2. growth of the gradient: eight consecutive ``train_step`` calls (AdamW,
   as ``chip_smoke.time_train`` runs them) from the checkpoint; at the step
   whose gradient norm jumps (``--spike-step``) the launch of E with the
   largest dxg is run again by the kernel, by its plain version with the
   same bf16 streams and by the plain version in float64 (drg rounded to
   bf16, and not), with the per-frame size of dxg, the batch variance and
   the BN gain gamma / sqrt(var + eps) of the unit that grows most.
3. non-finite gradients: the same steps with the loss's STFT on torch.stft
   (as the port had it before; its gradient is not deterministic on a
   card, so each run takes its own trajectory), ``--attempts`` runs of
   ``--attempt-steps`` steps, every launch of E checked. The first launch
   that returns a non-finite output gets the analysis of 2, and the frames
   from a little before its first non-finite one to the end are saved
   (``witness_e.pt``) when they fit, for ``tests/witness_e_jax.py`` to run
   the JAX bf16 train kernel on them.

Run on a card from the repository root:

    python3 train_witness.py [--steps 8] [--attempts 24] [--out chiprun_out]

Prints one JSON object as its last line (also written to
``<out>/train_witness.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs

DEV = "cuda"
MAX_SAVE_BYTES = 56 << 20  # what a chip run may bring back, with room to spare
ZOO_LAYERS = tuple(f"zoo M {stack} layer {k}"
                   for stack in ("fullband", "section 0", "section 1", "section 2")
                   for k in (0, 1))


def same(a, b) -> bool:
    """Bitwise equal tensors (NaN equal to NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-300)).item()


def finite(ts) -> bool:
    return all(bool(torch.isfinite(t.float()).all()) for t in ts)


class Recorder:
    """Kernels D and E wrapped in ``gk`` to record ``(kind, args, outputs)``
    of each launch and, for E, to call ``on_e`` on them."""

    def __init__(self, gk, on_e=None):
        self.gk, self.on_e, self.calls = gk, on_e, []
        self.real = {k: getattr(gk, n) for k, n in (("D", "gsu_layer_train_fwd"),
                                                     ("E", "gsu_layer_train_bwd"))}

    def __enter__(self):
        for kind, name in (("D", "gsu_layer_train_fwd"), ("E", "gsu_layer_train_bwd")):
            real = self.real[kind]

            def wrapped(*args, _real=real, _kind=kind):
                out = _real(*args)
                detached = tuple(a.detach() if torch.is_tensor(a) else a for a in args)
                self.calls.append((_kind, detached, tuple(o.detach() for o in out)))
                if _kind == "E" and self.on_e is not None:
                    self.on_e(detached, out)
                return out
            wrapped.launches = real.launches  # the real wrapper counts through this name
            setattr(self.gk, name, wrapped)
        return self

    def __exit__(self, *exc):
        for kind, name in (("D", "gsu_layer_train_fwd"), ("E", "gsu_layer_train_bwd")):
            self.real[kind].launches = getattr(self.gk, name).launches
            setattr(self.gk, name, self.real[kind])

    def layer_of(self, xg_ptr):
        """The name of the layer whose D launch read the xg at ``xg_ptr``."""
        ds = [a for k, a, _ in self.calls if k == "D"]
        for i, a in enumerate(ds):
            if a[0].data_ptr() == xg_ptr:
                return ZOO_LAYERS[i % len(ZOO_LAYERS)]
        return "?"


def determinism(gk, apply, cfg, p, st, noisy, clean):
    from spiking_fullsubnet_torch.dsp.spectral import hann_window, stft_complex
    from spiking_fullsubnet_torch.recipes.denoise import denoise_loss
    runs = []
    for _ in range(2):
        q = cs.fresh(p)
        with Recorder(gk) as rec:
            loss, _ = cs.fwd_bwd(apply, cfg, q, st, noisy, clean)
        torch.cuda.synchronize()
        runs.append((loss, rec, [t.grad for t in cs.tensors_of(q)]))
    launches, first = [], None
    for i, ((k1, a1, o1), (_, a2, o2)) in enumerate(zip(runs[0][1].calls, runs[1][1].calls)):
        ins = all(same(x, y) for x, y in zip(a1, a2) if torch.is_tensor(x))
        outs = all(same(x, y) for x, y in zip(o1, o2))
        name = runs[0][1].layer_of(a1[0].data_ptr()) if k1 == "E" else None
        row = {"launch": i, "kernel": k1, "layer": name, "inputs_equal": ins,
               "outputs_equal": outs}
        if k1 == "E" and not ins:
            row["gout_rel_diff"] = rel(a1[2], a2[2])
        launches.append(row)
        if first is None and not (ins and outs):
            first = row
    grads = [rel(a, b) for a, b in zip(runs[0][2], runs[1][2])]
    # each recorded launch again on its own inputs
    again = {"D": [], "E": []}
    for kind, args, out in runs[0][1].calls:
        fn = runs[0][1].real[kind]
        again[kind].append(all(same(x, y) for x, y in zip(fn(*args), out)))
    # the loss's gradient twice from one graph
    q = cs.fresh(p)
    ey = apply(cfg, q, st, noisy, train=True)["enhanced_y"]
    ey_leaf = ey.detach().requires_grad_(True)
    loss = denoise_loss(ey_leaf, clean)["loss"]
    g1, = torch.autograd.grad(loss, ey_leaf, retain_graph=True)
    g2, = torch.autograd.grad(loss, ey_leaf)
    # torch.stft with reflect padding against the port's stft_complex
    x = ey.detach().clone().requires_grad_(True)
    win = hann_window(2048, x.dtype, x.device)

    def stft_grads(fn):
        out = []
        for _ in range(2):
            spec = fn(x)
            g, = torch.autograd.grad((spec.real.abs() + spec.imag.abs()).sum(), x)
            out.append(g)
        return out, spec
    t_g, t_spec = stft_grads(lambda v: torch.stft(v, 2048, 512, 2048, win, center=True,
                                                  pad_mode="reflect", return_complex=True))
    p_g, p_spec = stft_grads(lambda v: stft_complex(v, 2048, 512, 2048, pad_mode="reflect"))
    # the operations torch names as nondeterministic
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cs.fwd_bwd(apply, cfg, cs.fresh(p), st, noisy, clean)
            torch.stft(x, 2048, 512, 2048, win, center=True, pad_mode="reflect",
                       return_complex=True).abs().sum().backward()
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    named = sorted({str(w.message).split("\n")[0][:240] for w in caught
                    if "deterministic" in str(w.message)})
    return {"losses_equal": bool(torch.equal(runs[0][0], runs[1][0])),
            "loss": [runs[0][0].item(), runs[1][0].item()],
            "grad_leaves_equal": sum(g == 0.0 for g in grads), "grad_leaves": len(grads),
            "grad_leaf_max_rel_diff": max(grads),
            "first_launch_that_differs": first, "launches": launches,
            "kernel_again_equal": {k: all(v) for k, v in again.items()},
            "loss_grad_twice_equal": same(g1, g2),
            "torch_stft_reflect_grad_twice_equal": same(*t_g),
            "torch_stft_reflect_grad_twice_max_diff": (t_g[0] - t_g[1]).abs().max().item(),
            "port_stft_grad_twice_equal": same(*p_g),
            "port_stft_equals_torch_stft": same(p_spec.detach(), t_spec.detach()),
            "port_stft_grad_vs_torch_max_rel": rel(p_g[0], t_g[0]),
            "named_nondeterministic": named}


def growth(gk, args, out_k, tail, save):
    """Where E's recorded launch goes non-finite: kernel E again, its plain
    version with the same streams, the plain version in float64 (drg
    rounded to bf16, and not), each one's non-finite frames, the per-frame
    size of dxg of the unit that overflows, its batch variance and BN gain
    gamma / sqrt(var + eps) over the frames where it grows."""
    xg, y, gout, stats, whh, b2, bnp, H, shared, mode = args
    T = xg.shape[0]
    runs = {"kernel": gk.gsu_layer_train_bwd(*args),
            "plain bf16 streams": gk.layer_train_bwd_plain(*args)}
    a64 = cs.as_f64_d(args)
    runs["plain float64, drg rounded to bf16"] = gk.layer_train_bwd_plain(
        *a64, operands=torch.bfloat16)
    runs["plain float64"] = gk.layer_train_bwd_plain(*a64)
    torch.cuda.synchronize()
    res = {"kernel_again_equals_recorded": all(same(a, b) for a, b in zip(runs["kernel"], out_k))}

    def abs_finite(x):
        x = x.double()
        return torch.where(torch.isfinite(x), x.abs(), torch.zeros_like(x))

    def last_bad(dxg):
        bad = (~torch.isfinite(dxg.float())).flatten(1).any(1)
        return int(bad.nonzero().max()) if bool(bad.any()) else None
    for who, out in runs.items():
        res[who] = {"finite": finite(out), "last_nonfinite_frame": last_bad(out[0]),
                    "max_abs_finite_dxg": abs_finite(out[0]).max().item(),
                    "max_abs_finite_dbn": abs_finite(out[3]).max().item()}
    d64 = abs_finite(runs["plain float64"][0])  # [T, R, G]
    col = d64.amax(dim=(0, 1))
    j = int(col.argmax())
    unit = j % H
    per_t = d64[:, :, j].amax(dim=1)  # [T]
    var = stats[:, 1, unit].double()
    gain = (bnp[0, unit].double() / torch.sqrt(var + gk.BN_EPS))
    log10 = torch.log10(per_t.clamp_min(1e-300))
    grow = (log10 > log10.median() + 1).nonzero()  # frames 10x above the median
    lo = int(grow.min()) if grow.numel() else 0
    hi = int(grow.max()) if grow.numel() else T - 1
    frames = sorted(set(np.linspace(max(lo - 4, 0), min(hi + 4, T - 1), 30).astype(int).tolist())
                    | set(range(max(hi - 24, 0), min(hi + 5, T))))
    kd = runs["kernel"][0][:, :, j].float().abs().amax(dim=1)
    res["unit"] = {"column": j, "unit": unit, "gamma": bnp[0, unit].item(),
                   "growth_frames": [lo, hi],
                   "var_min_over_growth": var[lo:hi + 1].min().item(),
                   "var_median_all": var.median().item(),
                   "profile": [{"t": t, "f64_max_abs_dxg": per_t[t].item(),
                                "kernel_max_abs_dxg": kd[t].item(), "var": var[t].item(),
                                "bn_gain": gain[t].item()} for t in frames]}
    if not save:
        return res, None
    # the frames to save for the JAX witness: from a little before the first
    # non-finite one (in reverse time, the last) to the end
    t_bad = res["kernel"]["last_nonfinite_frame"]
    start = max(0, (t_bad if t_bad is not None else lo) - tail)
    sl = (xg[start:], y[start:], gout[start:], stats[start:])
    nbytes = sum(t.numel() * t.element_size() for t in sl)
    res["slice"] = {"start": start, "frames": T - start, "bytes": nbytes}
    if nbytes <= MAX_SAVE_BYTES:
        # E on the slice: its steps after the first are the whole run's
        part = gk.gsu_layer_train_bwd(*[t.contiguous() for t in sl], whh, b2, bnp, H, shared,
                                      mode)
        res["slice"]["kernel_slice_equals_whole_after_first_frame"] = same(
            part[0][1:], runs["kernel"][0][start + 1:])
        res["slice"]["saved"] = True
        blob = {"xg": sl[0].cpu(), "y": sl[1].cpu(), "gout": sl[2].cpu(), "stats": sl[3].cpu(),
                "whh": whh.cpu(), "b2": b2.cpu(), "bnp": bnp.cpu(), "hidden": H,
                "shared": shared, "mode": mode, "start": start, "T": T,
                "kernel_dxg": part[0].cpu()}
    else:
        res["slice"]["saved"] = False
        blob = None
    return res, blob


def torch_stft_complex(y, n_fft, hop_length, win_length, *, center=True, pad_mode="constant",
                       normalized=False):
    """The port's ``stft_complex`` as it was before it wrote torch.stft's
    steps out: torch.stft itself, whose reflect padding sums its gradient
    with atomic adds on a card, so that no two backwards are alike."""
    from spiking_fullsubnet_torch.dsp.spectral import _pad_window, hann_window
    window = _pad_window(hann_window(win_length, y.dtype, y.device), win_length, n_fft)
    spec = torch.stft(y.reshape(-1, y.shape[-1]), n_fft, hop_length, n_fft, window,
                      center=center, pad_mode=pad_mode, normalized=normalized,
                      return_complex=True)
    return spec.reshape(y.shape[:-1] + spec.shape[-2:])


def hunt(gk, apply, cfg, p, st0, noisy, clean, attempts, steps, label, keep_step=None):
    """Consecutive train steps, ``attempts`` times from the same weights;
    stops at the first launch of E that returns a non-finite output.
    ``keep_step``: also keep every launch of E (arguments and outputs) of
    that step of the first attempt."""
    from spiking_fullsubnet_torch.recipes.denoise import adamw, train_step
    found, kept = {}, []

    def on_e(args, out):
        if not found and not finite(out):
            found["xg_ptr"] = args[0].data_ptr()
            found["args"] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            found["out"] = tuple(o.clone() for o in out)
            found["inputs_finite"] = finite([a for a in args if torch.is_tensor(a)])
    steps_run, log_steps = 0, []
    for attempt in range(attempts):
        params = cs.fresh(p)
        opt = adamw(cs.tensors_of(params))
        st = st0
        for step in range(steps):
            with Recorder(gk, on_e) as rec:
                ld, st, norm = train_step(apply, cfg, params, st, noisy, clean, opt)
                torch.cuda.synchronize()
            steps_run += 1
            log_steps.append({"attempt": attempt, "step": step, "loss": ld["loss"].item(),
                              "grad_norm": norm.item()})
            if attempt == 0 and step == keep_step:
                kept = [(rec.layer_of(a[0].data_ptr()), a, o) for k, a, o in rec.calls
                        if k == "E"]
            if found:
                found.update(attempt=attempt, step=step, layer=rec.layer_of(found["xg_ptr"]))
                break
            rec.calls.clear()
        if found:
            break
    out = {"label": label, "steps_run": steps_run, "steps": log_steps,
           "nonfinite": bool(found)}
    if found:
        out.update({k: found[k] for k in ("attempt", "step", "layer", "inputs_finite")})
    return out, found, kept


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=8, help="consecutive steps, deterministic run")
    ap.add_argument("--spike-step", type=int, default=6,
                    help="the deterministic run's step whose largest E launch is analysed")
    ap.add_argument("--attempts", type=int, default=24, help="runs with torch.stft's loss")
    ap.add_argument("--attempt-steps", type=int, default=3)
    ap.add_argument("--tail", type=int, default=8, help="frames saved before the first bad one")
    ap.add_argument("--out", default="chiprun_out")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_witness: needs a CUDA device", file=sys.stderr)
        return 2
    from spiking_fullsubnet_torch.losses import losses
    from spiking_fullsubnet_torch.models.spiking_fullsubnet import (
        SpikingFullSubNet, separator_config, spiking_fullsubnet_apply)
    from spiking_fullsubnet_torch.ops import gsu_kernels as gk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    dev = torch.device(DEV)
    gk.build_kernels()
    base = replace(separator_config(norm_type="offline_laplace_norm", shared_weights=True,
                                    bn=True), scan_mode="stream", collect_layer_outputs=False)
    model = SpikingFullSubNet.from_npz(str(cs.ZOO_M), base, device=dev)
    _, _, noisy, clean = cs.training_batches(dev)
    torch.set_grad_enabled(True)
    apply = spiking_fullsubnet_apply
    p, st = model.param_tree(), model.state_tree()
    bf16 = replace(base, compute_dtype="bfloat16")
    out_dir = Path(a.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    report = {"card": cs.card_name(), "torch": torch.__version__}

    def stamp(what, obj):
        cs.log(f"[witness] {what} at {time.perf_counter() - t0:.1f} s: {json.dumps(obj)}")

    report["determinism"] = determinism(gk, apply, bf16, p, st, noisy, clean)
    stamp("determinism", {k: v for k, v in report["determinism"].items() if k != "launches"})
    # the deterministic run: its largest gradient step, analysed launch by launch
    h, found, kept = hunt(gk, apply, bf16, p, st, noisy, clean, 1, a.steps, "deterministic",
                          keep_step=a.spike_step)
    report["deterministic_run"] = h
    stamp("deterministic run", h)
    if kept:
        sizes = [(o[0].float().abs().max().item(), i) for i, (_, _, o) in enumerate(kept)]
        report["spike_step_launches"] = [{"layer": kept[i][0], "max_abs_dxg": m}
                                         for m, i in sizes]
        layer, args, out = kept[max(sizes)[1]]
        g, _ = growth(gk, args, out, a.tail, save=False)
        report["spike_step_growth"] = dict(g, layer=layer)
        stamp("spike step growth", report["spike_step_growth"])
    del kept
    # runs as they were before the loss's STFT was written out: every
    # backward slightly different, so the trajectories part after a step
    real_stft = losses.stft_complex
    losses.stft_complex = torch_stft_complex
    try:
        h, found, _ = hunt(gk, apply, bf16, p, st, noisy, clean, a.attempts, a.attempt_steps,
                           "torch.stft loss")
    finally:
        losses.stft_complex = real_stft
    report["perturbed_hunt"] = h
    stamp("perturbed hunt", {k: v for k, v in h.items() if k != "steps"})
    if found:
        g, blob = growth(gk, found["args"], found["out"], a.tail, save=True)
        report["nonfinite_growth"] = g
        if blob is not None:
            torch.save(blob, out_dir / "witness_e.pt")
        stamp("non-finite launch growth", g)
    report["seconds"] = time.perf_counter() - t0
    text = json.dumps(report)
    (out_dir / "train_witness.json").write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
