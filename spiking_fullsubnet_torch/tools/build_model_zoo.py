"""Build the model zoo and its leaderboard from the reference's weights
(counterpart of ``tools/build_model_zoo.py``):

    python -m spiking_fullsubnet_torch.tools.build_model_zoo \\
        --ref-zoo <checkout>/model_zoo/intel_ndns/spike_fsb \\
        [--out model_zoo] [--sizes s m l xl alif] [--utts 8] [--device cuda|cpu]

``--ref-zoo`` (or ``$SFSN_REF_ZOO``) names a tree of the reference's
``model_zoo/intel_ndns/spike_fsb``: ``baseline_<size>/`` holding the config
TOML the weights were saved with and ``checkpoints/best/pytorch_model.bin``
(the generator) or ``pytorch_model_1.bin`` (the GAN discriminator). Without
it the tool says that none was given and exits.

- ``baseline_s`` and ``baseline_m``: the generator is imported
  (``runtime/convert``), saved as ``<out>/intel_ndns/spike_fsb/
  baseline_<size>.npz``, reloaded from it, and run on ``--device`` (the
  layered forward: kernel F on the card) over a speech-like fixture of
  ``--utts`` 4 s utterances (seed 7) under the checkpoint's own config;
  SI-SDR and the neuromorphic proxies (synops reduced on the device) make
  its row.
- ``baseline_l`` and ``baseline_xl``: the reference ships no generator for
  them; the architecture is built from the config and its parameter count
  checked against the published table, and the discriminator, where it
  ships, is imported to ``baseline_<size>_discriminator.npz``.
- ``alif``: neither weights nor code ship; its row is documentation.

The entries go to ``<out>/entries_framework.json`` and the board to
``<out>/metricsboard_framework.{md,yml}`` (``metricsboard_writeout``).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import tomllib
from pathlib import Path

import numpy as np
import torch

from ..metrics.neuromorphic import compute_neuronops, synops_device
from ..models.spiking_fullsubnet import (separator_config, spiking_fullsubnet_apply,
                                         spiking_fullsubnet_init)
from ..runtime.convert import (flat_paths, import_discriminator, import_spiking_fullsubnet,
                               load_npz, load_torch_state_dict, save_npz)
from ..runtime.device import resolve_device
from . import metricsboard_writeout
from ._common import add_device

ALL_SIZES = ["s", "m", "l", "xl", "alif"]
GENERATOR_SIZES = {"s", "m"}  # sizes whose generator weights ship
# published parameter counts (the reference zoo's leaderboard tables)
PUBLISHED_PARAMS = {
    "baseline_s": 521_000, "baseline_m": 954_000,
    "baseline_l": 1_289_000, "baseline_xl": 1_798_000,
}


def shipped_model_args(ckpt_dir: Path) -> dict:
    """``[model_g.args]`` (or ``[model.args]``) of the config TOML stored
    beside the checkpoint: the config the weights were saved with."""
    tomls = sorted(ckpt_dir.glob("*.toml"))
    if not tomls:
        raise FileNotFoundError(f"no shipped config TOML under {ckpt_dir}")
    cfg = tomllib.loads(tomls[0].read_text())
    section = cfg.get("model_g") or cfg.get("model") or {}
    return dict(section.get("args") or {})


def speechlike_fixture(n_utts: int, seconds: float = 4.0, sr: int = 16000, seed: int = 7):
    """Speech-like utterances: AM harmonic stacks with a drifting F0, in
    noise; yields (clean, noisy)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    for _ in range(n_utts):
        f0 = rng.uniform(90, 220) + rng.uniform(10, 40) * np.sin(2 * np.pi * rng.uniform(1, 4) * t)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        sig = sum(np.sin(k * phase) / k for k in range(1, 9))
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6)))
        clean = (0.2 * env * sig).astype(np.float32)
        noise = (rng.uniform(0.03, 0.1) * rng.standard_normal(len(t))).astype(np.float32)
        yield clean, clean + noise


def si_sdr(est: np.ndarray, ref: np.ndarray) -> float:
    alpha = float(np.dot(est, ref) / np.dot(ref, ref))
    return float(10 * np.log10(np.sum((alpha * ref) ** 2)
                               / (np.sum((alpha * ref - est) ** 2) + 1e-12)))


def _entry_base(model_desc: str) -> dict:
    buffer_latency_ms = 128 / 16000 * 1e3
    dns_delays_ms = 0.036  # the challenge's encoder and decoder accounting
    return {
        "team": "spiking_fullsubnet_torch",
        "model": model_desc,
        "date": datetime.date.today().isoformat(),
        "SI-SNR": None,
        "MOS_ovrl": None,
        "latency_enc+dec_ms": dns_delays_ms,
        "latency_total_ms": round(buffer_latency_ms + dns_delays_ms, 3),
        "power_proxy_Ops/s": None,
        "PDP_proxy_Ops": None,
        "neuron_ops": None,
        "params": None,
        "size_kilobytes": None,
        "model_path": None,
    }


def evaluate(cfg, params, state, utts: int, dev: torch.device):
    """(SI-SDRs, synops, neuron ops) of each fixture utterance through the
    forward of ``cfg`` on ``dev``, the audio in the weights' type."""
    dtype = flat_paths(params)["fb/stack/layers/0/weight_hh"].dtype
    sisdrs, synops, neuronops = [], [], []
    with torch.no_grad():
        for clean, noisy in speechlike_fixture(utts):
            out = spiking_fullsubnet_apply(cfg, params, state,
                                           torch.from_numpy(noisy[None]).to(dev, dtype))
            sisdrs.append(si_sdr(out["enhanced_y"][0].cpu().numpy(), clean))
            fb, sb = out["fb_all_layer_outputs"], out["sb_all_layer_outputs"]
            synops.append(float(synops_device(fb, sb, shared_weights=cfg.shared_weights)))
            neuronops.append(float(compute_neuronops(fb, sb)))
    return sisdrs, synops, neuronops


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="model_zoo")
    ap.add_argument("--sizes", nargs="+", default=ALL_SIZES, choices=ALL_SIZES)
    ap.add_argument("--utts", type=int, default=8)
    ap.add_argument("--ref-zoo", default=os.environ.get("SFSN_REF_ZOO"),
                    help="the reference's model_zoo/intel_ndns/spike_fsb tree "
                         "(default $SFSN_REF_ZOO)")
    add_device(ap)
    args = ap.parse_args(argv)
    if not args.ref_zoo:
        ap.error("no reference zoo was given: pass --ref-zoo <.../model_zoo/intel_ndns/spike_fsb> "
                 "or set SFSN_REF_ZOO")
    dev = resolve_device(args.device)

    out_dir = Path(args.out) / "intel_ndns" / "spike_fsb"
    out_dir.mkdir(parents=True, exist_ok=True)
    entries = []
    for short in args.sizes:
        if short == "alif":
            e = _entry_base("ALIF (NOT reproducible from the reference snapshot: no weights "
                            "shipped and the config's model module sdnn_delays.spk_model."
                            "ALIF_Model is absent — stale import; see ops/lif.py for the "
                            "framework ALIF)")
            e["latency_total_ms"] = 16.036  # published: a two-hop buffer
            e["params"] = 1_580_000
            entries.append(e)
            print("ALIF: documented only (the reference ships neither weights nor code)",
                  flush=True)
            continue

        size = f"baseline_{short}"
        ckpt_dir = Path(args.ref_zoo) / size
        cfg = separator_config(**shipped_model_args(ckpt_dir))
        template, _ = spiking_fullsubnet_init(0, cfg, device="cpu")
        n_params = sum(t.numel() for t in flat_paths(template).values())
        published = PUBLISHED_PARAMS[size]
        if abs(n_params - published) > 0.02 * published:
            raise ValueError(f"{size}: the built architecture has {n_params} params, the "
                             f"published table ~{published}")
        best = ckpt_dir / "checkpoints" / "best"

        if short in GENERATOR_SIZES:
            sd = load_torch_state_dict(str(best / "pytorch_model.bin"), dev)
            params, state = import_spiking_fullsubnet(sd, cfg)
            npz_path = out_dir / f"{size}.npz"
            save_npz(str(npz_path), {"params": params, "state": state})
            restored = load_npz(str(npz_path), device=dev)  # the reload users make
            sisdrs, synops, neuronops = evaluate(cfg, restored["params"], restored["state"],
                                                 args.utts, dev)
            e = _entry_base(f"{size} (framework-native, shipped config: "
                            f"norm_type={cfg.norm_type})")
            e.update({
                "SI-SNR": round(float(np.mean(sisdrs)), 2),
                "power_proxy_Ops/s": round(float(np.mean(synops)) / (cfg.hop_length / 16000), 1),
                "PDP_proxy_Ops": round(float(np.mean(synops)), 1),
                "neuron_ops": round(float(np.mean(neuronops)), 1),
                "params": n_params,
                "size_kilobytes": round(npz_path.stat().st_size / 1024, 1),
                "model_path": str(npz_path),
            })
            print(f"{size}: SI-SDR {e['SI-SNR']} dB, synops {e['PDP_proxy_Ops']}, "
                  f"params {n_params}", flush=True)
        else:
            d_path = None
            if (best / "pytorch_model_1.bin").exists():
                d_params = import_discriminator(
                    load_torch_state_dict(str(best / "pytorch_model_1.bin"), dev))
                d_path = out_dir / f"{size}_discriminator.npz"
                save_npz(str(d_path), d_params)
            e = _entry_base(f"{size} (architecture-only: upstream snapshot ships no generator "
                            "weights — checkpoints/best has only the GAN discriminator, "
                            "imported alongside)")
            e.update({"params": n_params, "model_path": str(d_path) if d_path else None,
                      "size_kilobytes": round(d_path.stat().st_size / 1024, 1) if d_path
                      else None})
            print(f"{size}: architecture verified ({n_params} params ~ published {published}); "
                  f"discriminator -> {d_path}", flush=True)
        entries.append(e)

    entries_path = Path(args.out) / "entries_framework.json"
    entries_path.write_text(json.dumps(entries, indent=2))
    stem = Path(args.out) / "metricsboard_framework"
    metricsboard_writeout.main(["-I", str(entries_path), "-O", str(stem)])
    print(f"Wrote {stem}.{{yml,md}}")
    return entries


if __name__ == "__main__":
    main()
