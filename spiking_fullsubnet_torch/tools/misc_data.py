"""Dataset wrangling: split_scp, dirs2txt, txt2duration, select_subset,
trim_seg, seek_best_score (counterpart of ``tools/misc_data.py``):

    python -m spiking_fullsubnet_torch.tools.misc_data [--workers N] [--device cuda|cpu] \
        <subcommand> ...

Reads, computes and writes on the host (numpy and scipy, the port's
``dsp/io`` and ``dsp/norms``, as the JAX tool and the port's input
pipeline do). Like every entry point of the port it wants the card
(``--device cuda``, the default) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import random
import re
from pathlib import Path

from ..dsp.io import find_files, load_wav, save_wav
from ..runtime.device import resolve_device
from ._common import add_device


def cmd_split_scp(args):
    lines = [line for line in open(args.scp) if line.strip()]
    n = args.num_splits
    for i in range(n):
        chunk = lines[i::n]
        out = Path(args.scp).with_suffix(f".{i}.scp")
        out.write_text("".join(chunk))
        print(f"{out}: {len(chunk)} lines")


def cmd_dirs2txt(args):
    files = find_files(args.dir)
    Path(args.output).write_text("\n".join(files) + "\n")
    print(f"{args.output}: {len(files)} paths")


def _pmap(fn, items, workers: int):
    """Process-pool map for the per-file loops (serial when workers <= 1);
    the reference parallelizes these with joblib."""
    if workers <= 1:
        return [fn(it) for it in items]
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(fn, items, chunksize=16))


def _duration_one(packed):
    path, sr = packed
    return len(load_wav(path)) / sr


def cmd_txt2duration(args):
    items = [(line.strip().split()[-1], args.sr)
             for line in open(args.txt) if line.strip()]
    total = sum(_pmap(_duration_one, items, args.workers))
    print(f"total duration: {total:.1f} s ({total / 3600:.2f} h)")


def cmd_select_subset(args):
    files = find_files(args.dir)
    random.seed(args.seed)
    subset = random.sample(files, min(args.num, len(files)))
    Path(args.output).write_text("\n".join(subset) + "\n")
    print(f"{args.output}: {len(subset)} paths")


def _trim_one(packed):
    f, seconds, sr, output_dir = packed
    y = load_wav(f, sr=sr)
    y = y[: int(seconds * sr)]
    dst = Path(output_dir) / Path(f).name
    dst.parent.mkdir(parents=True, exist_ok=True)
    save_wav(y, dst, sr)


def cmd_trim_seg(args):
    items = [(f, args.seconds, args.sr, args.output_dir) for f in find_files(args.dir)]
    _pmap(_trim_one, items, args.workers)
    print("done")


def cmd_seek_best_score(args):
    """Scan a training logfile for the best validation score
    (reference tools/seek_best_score_from_logfile.py)."""
    pat = re.compile(r"Found new best score: ([-\d.]+)")
    best, line_no = None, -1
    for i, line in enumerate(open(args.logfile)):
        m = pat.search(line)
        if m:
            best, line_no = float(m.group(1)), i
    print(f"best score: {best} (line {line_no})")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workers", type=int, default=1,
                   help="process-pool size for the per-file subcommands")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("split_scp")
    s.add_argument("scp")
    s.add_argument("--num_splits", type=int, default=4)
    s.set_defaults(func=cmd_split_scp)

    s = sub.add_parser("dirs2txt")
    s.add_argument("dir")
    s.add_argument("-O", "--output", default="files.txt")
    s.set_defaults(func=cmd_dirs2txt)

    s = sub.add_parser("txt2duration")
    s.add_argument("txt")
    s.add_argument("--sr", type=int, default=16000)
    s.set_defaults(func=cmd_txt2duration)

    s = sub.add_parser("select_subset")
    s.add_argument("dir")
    s.add_argument("--num", type=int, required=True)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("-O", "--output", default="subset.txt")
    s.set_defaults(func=cmd_select_subset)

    s = sub.add_parser("trim_seg")
    s.add_argument("dir")
    s.add_argument("--seconds", type=float, required=True)
    s.add_argument("-O", "--output_dir", required=True)
    s.add_argument("--sr", type=int, default=16000)
    s.set_defaults(func=cmd_trim_seg)

    s = sub.add_parser("seek_best_score")
    s.add_argument("logfile")
    s.set_defaults(func=cmd_seek_best_score)

    add_device(p)
    args = p.parse_args(argv)
    resolve_device(args.device)
    args.func(args)


if __name__ == "__main__":
    main()
