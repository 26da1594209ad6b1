"""Pack a noise corpus into one HDF5 file, one dataset a clip keyed by its
file stem (counterpart of ``tools/noise_to_hdf5.py``):

    python -m spiking_fullsubnet_torch.tools.noise_to_hdf5 /data/noise /data/noise_fp16.hdf5 \
        [--sr 16000] [--dtype float16|float32] [--device cuda|cpu]

Needs h5py; without it the tool exits with the JAX tool's message.
Reads, computes and writes on the host (numpy and scipy, the port's
``dsp/io`` and ``dsp/norms``, as the JAX tool and the port's input
pipeline do). Like every entry point of the port it wants the card
(``--device cuda``, the default) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from ..dsp.io import find_files, load_wav
from ..runtime.device import resolve_device
from ._common import add_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("noise_dir")
    p.add_argument("output", help="output .hdf5 path")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--dtype", default="float16", choices=["float16", "float32"])
    add_device(p)
    args = p.parse_args(argv)
    resolve_device(args.device)

    try:
        import h5py
    except ImportError:
        sys.exit("h5py is not installed; `pip install h5py`.")

    paths = find_files(args.noise_dir)
    if not paths:
        sys.exit(f"No wav files found under {args.noise_dir}")

    with h5py.File(args.output, "w") as hf:
        hf.attrs["sr"] = args.sr
        for fpath in paths:
            y = load_wav(fpath, sr=args.sr)
            if y.ndim == 2:
                y = y.mean(axis=0)
            stem = Path(fpath).stem
            hf.create_dataset(stem, data=y.astype(args.dtype))
    print(f"Wrote {len(paths)} clips to {args.output}")


if __name__ == "__main__":
    main()
