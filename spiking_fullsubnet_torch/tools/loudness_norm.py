"""Batch loudness normalization of a WAV tree to a target dBFS
(counterpart of ``tools/loudness_norm.py``):

    python -m spiking_fullsubnet_torch.tools.loudness_norm -I in_dir -O out_dir \
        [--lvl -25] [--sr 16000] [--device cuda|cpu]

Reads, computes and writes on the host (numpy and scipy, the port's
``dsp/io`` and ``dsp/norms``, as the JAX tool and the port's input
pipeline do). Like every entry point of the port it wants the card
(``--device cuda``, the default) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..dsp.io import find_files, load_wav, save_wav
from ..dsp.norms import loudness_rms_norm
from ..runtime.device import resolve_device
from ._common import add_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-I", "--input_dir", required=True)
    p.add_argument("-O", "--output_dir", required=True)
    p.add_argument("--lvl", type=float, default=-25, help="target dBFS")
    p.add_argument("--sr", type=int, default=16000)
    add_device(p)
    args = p.parse_args(argv)
    resolve_device(args.device)

    for f in find_files(args.input_dir):
        y = load_wav(f, sr=args.sr)
        y, _ = loudness_rms_norm(y, lvl=args.lvl)
        dst = Path(args.output_dir) / Path(f).relative_to(Path(args.input_dir).resolve())
        dst.parent.mkdir(parents=True, exist_ok=True)
        save_wav(y, dst, args.sr)
    print("done")


if __name__ == "__main__":
    main()
