"""Traffic generator ``tones``: the synthetic recipe of the program's
``data/synthetic.py`` rewritten for the device. Each utterance is a tone at
f0 with its second and third harmonics, amplitude-modulated at ``mod_hz``,
plus Gaussian noise at an SNR drawn per utterance. Every seed gets the same
sizes; the seed changes only the values.

Keys of a mix: ``batch`` (utterances a batch), ``seconds`` (each
utterance's length), ``f0_hz``, ``mod_hz`` and ``snr_db`` (uniform ranges).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from gpubench.weights import seed_of

REQUIRED = ("batch", "seconds", "f0_hz", "mod_hz", "snr_db")


def _uniform(gen, n: int, lo_hi, device) -> torch.Tensor:
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device, dtype=torch.float64)


def make_batch(spec: Dict[str, Any], seed: int, index: int, device: torch.device,
               chunk: int = 32) -> Dict[str, Any]:
    """Pool batch ``index``: ``noisy`` and ``clean``, float32 ``[batch, n]``
    on ``device``, and ``audio_s``, the audio-seconds it holds. The phase is
    taken in float64 so that a 30 s tone keeps its frequency."""
    B, sr = spec["batch"], spec["sample_rate"]
    n = int(round(spec["seconds"] * sr))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_of(seed, f"traffic/{index}"))
    f0 = _uniform(gen, B, spec["f0_hz"], device)
    fm = _uniform(gen, B, spec["mod_hz"], device)
    snr = _uniform(gen, B, spec["snr_db"], device)
    noise = torch.randn(B, n, generator=gen, device=device)
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    clean = torch.empty(B, n, device=device)
    for r0 in range(0, B, chunk):
        rows = slice(r0, min(r0 + chunk, B))
        ph = (2.0 * math.pi) * f0[rows, None] * t
        env = 1.0 + 0.5 * torch.sin((2.0 * math.pi) * fm[rows, None] * t)
        clean[rows] = (0.25 * torch.sin(ph) * env + 0.1 * torch.sin(2.0 * ph)
                       + 0.05 * torch.sin(3.0 * ph)).float()
    clean_rms = clean.square().mean(-1).sqrt()
    noise_rms = noise.square().mean(-1).sqrt()
    gain = clean_rms / (10.0 ** (snr.float() / 20.0)) / (noise_rms + 1e-12)
    return {"noisy": clean + gain[:, None] * noise, "clean": clean, "audio_s": B * n / sr}
