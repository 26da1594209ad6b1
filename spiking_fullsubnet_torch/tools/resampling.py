"""Batch resampling of a WAV tree (counterpart of ``tools/resampling.py``):

    python -m spiking_fullsubnet_torch.tools.resampling -I in_dir -O out_dir --sr 8000 \
        [--num_workers 8] [--device cuda|cpu]

Reads, computes and writes on the host (numpy and scipy, the port's
``dsp/io`` and ``dsp/norms``, as the JAX tool and the port's input
pipeline do). Like every entry point of the port it wants the card
(``--device cuda``, the default) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

from ..dsp.io import find_files, load_wav, save_wav
from ..runtime.device import resolve_device
from ._common import add_device


def resample_one(args):
    src, src_root, dst_root, sr = args
    y = load_wav(src, sr=sr)
    dst = Path(dst_root) / Path(src).relative_to(Path(src_root).resolve())
    dst.parent.mkdir(parents=True, exist_ok=True)
    save_wav(y, dst, sr)
    return str(dst)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-I", "--input_dir", required=True)
    p.add_argument("-O", "--output_dir", required=True)
    p.add_argument("--sr", type=int, required=True)
    p.add_argument("--num_workers", type=int, default=8)
    add_device(p)
    args = p.parse_args(argv)
    resolve_device(args.device)

    files = find_files(args.input_dir)
    jobs = [(f, args.input_dir, args.output_dir, args.sr) for f in files]
    if args.num_workers > 1:
        with ProcessPoolExecutor(max_workers=args.num_workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            done = list(pool.map(resample_one, jobs))
    else:
        done = [resample_one(j) for j in jobs]
    print(f"Resampled {len(done)} files to {args.sr} Hz under {args.output_dir}")


if __name__ == "__main__":
    main()
