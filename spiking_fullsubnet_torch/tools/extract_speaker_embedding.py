"""Per-utterance speaker embeddings to ``.npy`` files under the source
tree's structure (counterpart of ``tools/extract_speaker_embedding.py``):

    python -m spiking_fullsubnet_torch.tools.extract_speaker_embedding -s src_dir -o dest_dir \
        [--backend auto|ecapa|logmel] [--sr 16000] [--device cuda|cpu]

Backends:

- ``ecapa`` (``auto`` picks it where speechbrain imports): speechbrain's
  ECAPA-TDNN VoxCeleb embeddings on ``--device``, as the reference tool;
  without speechbrain ``--backend ecapa`` exits with the JAX tool's
  message.
- ``logmel``: log-mel filterbank statistics (mean and std over time, 2 x 64
  values), numpy on the host: not a speaker-verification embedding, but
  self-contained, for clustering and deduplicating a corpus.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from ..dsp.io import find_files, load_wav
from ..runtime.device import resolve_device
from ._common import add_device


def _logmel_embedding(y: np.ndarray, sr: int, n_mels: int = 64) -> np.ndarray:
    import numpy.fft as fft

    n_fft, hop = 512, 160
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    t = 1 + (len(y) - n_fft) // hop if len(y) >= n_fft else 1
    if len(y) < n_fft:
        y = np.pad(y, (0, n_fft - len(y)))
    frames = np.stack([y[i * hop : i * hop + n_fft] for i in range(t)])
    spec = np.abs(fft.rfft(frames * win, axis=-1)) ** 2  # [T, F]

    # triangular mel filterbank
    def hz2mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    pts = mel2hz(np.linspace(hz2mel(0), hz2mel(sr / 2), n_mels + 2))
    bins = np.floor((n_fft + 1) * pts / sr).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for m in range(1, n_mels + 1):
        lo, c, hi = bins[m - 1], bins[m], bins[m + 1]
        for k in range(lo, c):
            fb[m - 1, k] = (k - lo) / max(c - lo, 1)
        for k in range(c, hi):
            fb[m - 1, k] = (hi - k) / max(hi - c, 1)
    mel = np.log(spec @ fb.T + 1e-10)  # [T, M]
    return np.concatenate([mel.mean(0), mel.std(0)]).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-s", "--src_dir", required=True)
    p.add_argument("-o", "--dest_dir", required=True)
    p.add_argument("--backend", choices=["auto", "ecapa", "logmel"], default="auto")
    p.add_argument("--sr", type=int, default=16000)
    add_device(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    backend = args.backend
    classifier = None
    if backend in ("auto", "ecapa"):
        try:
            from speechbrain.pretrained import EncoderClassifier  # type: ignore

            classifier = EncoderClassifier.from_hparams(
                source="speechbrain/spkrec-ecapa-voxceleb", run_opts={"device": str(dev)}
            )
            backend = "ecapa"
        except ImportError:
            if backend == "ecapa":
                sys.exit("speechbrain is not installed; use --backend logmel.")
            backend = "logmel"
    print(f"Backend: {backend}")

    src_dir = Path(args.src_dir).expanduser().absolute()
    dest_dir = Path(args.dest_dir).expanduser().absolute()
    paths = find_files(str(src_dir))
    print(f"Found {len(paths)} files in {src_dir}.")

    for path in paths:
        y = load_wav(path, sr=args.sr)
        if y.ndim == 2:
            y = y.mean(axis=0)
        if backend == "ecapa":
            emb = classifier.encode_batch(torch.from_numpy(y)[None].to(dev))
            emb = emb.squeeze().cpu().numpy()
        else:
            emb = _logmel_embedding(y, args.sr)
        dest = dest_dir / Path(path).relative_to(src_dir)
        dest.parent.mkdir(parents=True, exist_ok=True)
        np.save(dest.with_suffix(".npy"), emb)
    print(f"Wrote {len(paths)} embeddings under {dest_dir}")


if __name__ == "__main__":
    main()
