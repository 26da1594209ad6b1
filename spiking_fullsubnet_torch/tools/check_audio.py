"""Dataset hygiene checks: clipping and activity, existence, missing pairs,
mono, non-signal (counterpart of ``tools/check_audio.py``):

    python -m spiking_fullsubnet_torch.tools.check_audio [--workers N] [--device cuda|cpu] \
        clip_activity DIR | existence SCP | missing_pair DIR_A DIR_B | mono DIR | non_signal DIR

Reads, computes and writes on the host (numpy and scipy, the port's
``dsp/io`` and ``dsp/norms``, as the JAX tool and the port's input
pipeline do). Like every entry point of the port it wants the card
(``--device cuda``, the default) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from ..dsp.io import find_files, load_wav
from ..dsp.norms import activity_detector, is_clipped
from ..runtime.device import resolve_device
from ._common import add_device


def _pmap(fn, items, workers: int):
    """Map fn over items with a process pool (the per-file checks are
    IO + numpy bound — the reference parallelizes the same loops with
    joblib, tools/check_clip_activity.py). Serial when workers <= 1."""
    if workers <= 1:
        return [fn(it) for it in items]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(fn, items, chunksize=16))


def _check_clip_activity_one(packed):
    f, clip_threshold, min_activity, sr = packed
    y = load_wav(f)
    clipped = is_clipped(y, clip_threshold)
    activity = activity_detector(y, fs=sr)
    if clipped or activity < min_activity:
        return f"{f}\tclipped={clipped}\tactivity={activity:.3f}"
    return None


def cmd_clip_activity(args):
    items = [(f, args.clip_threshold, args.min_activity, args.sr)
             for f in find_files(args.dir)]
    for line in _pmap(_check_clip_activity_one, items, args.workers):
        if line:
            print(line)


def cmd_existence(args):
    missing = [line for line in open(args.scp) if not Path(line.split()[-1].strip()).exists()]
    print(f"{len(missing)} missing files")
    for m in missing[:50]:
        print(m.strip())


def cmd_missing_pair(args):
    a = {Path(f).stem for f in find_files(args.dir_a)}
    b = {Path(f).stem for f in find_files(args.dir_b)}
    print("only in A:", sorted(a - b)[:50])
    print("only in B:", sorted(b - a)[:50])


def _check_mono_one(f):
    y = load_wav(f)
    if y.ndim != 1:
        return f"{f}\tchannels={y.shape[0]}"
    return None


def cmd_mono(args):
    for line in _pmap(_check_mono_one, find_files(args.dir), args.workers):
        if line:
            print(line)


def _check_non_signal_one(packed):
    f, min_rms = packed
    y = load_wav(f)
    rms = float(np.sqrt(np.mean(y**2)))
    if rms < min_rms:
        return f"{f}\trms={rms:.2e}"
    return None


def cmd_non_signal(args):
    items = [(f, args.min_rms) for f in find_files(args.dir)]
    for line in _pmap(_check_non_signal_one, items, args.workers):
        if line:
            print(line)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workers", type=int, default=1,
                   help="process-pool size for the per-file checks")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("clip_activity")
    s.add_argument("dir")
    s.add_argument("--clip_threshold", type=float, default=0.999)
    s.add_argument("--min_activity", type=float, default=0.6)
    s.add_argument("--sr", type=int, default=16000)
    s.set_defaults(func=cmd_clip_activity)

    s = sub.add_parser("existence")
    s.add_argument("scp")
    s.set_defaults(func=cmd_existence)

    s = sub.add_parser("missing_pair")
    s.add_argument("dir_a")
    s.add_argument("dir_b")
    s.set_defaults(func=cmd_missing_pair)

    s = sub.add_parser("mono")
    s.add_argument("dir")
    s.set_defaults(func=cmd_mono)

    s = sub.add_parser("non_signal")
    s.add_argument("dir")
    s.add_argument("--min_rms", type=float, default=1e-4)
    s.set_defaults(func=cmd_non_signal)

    add_device(p)
    args = p.parse_args(argv)
    resolve_device(args.device)
    args.func(args)


if __name__ == "__main__":
    main()
