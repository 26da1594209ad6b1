"""Offline metrics of estimated against reference WAVs (counterpart of
``tools/calculate_metrics.py``):

    python -m spiking_fullsubnet_torch.tools.calculate_metrics -E est_dir -R ref_dir \\
        -M si_sdr stoi [dnsmos pesq_wb] -O metrics.csv [--sr 16000] [--num_workers 8] \\
        [--device cuda|cpu]

The files pair in sorted order. SI-SDR, STOI and PESQ are the port's host
metrics (``metrics/metrics.py``, numpy); DNSMOS runs its ONNX models on
``--device`` (onnxruntime's CUDA provider on the card). The CSV has the
columns and cells that the JAX tool's pandas writes: ``file``, then each
metric's keys in order; the mean of every numeric column is printed.
"""

from __future__ import annotations

import argparse
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

from ..dsp.io import find_files, load_wav
from ..metrics import SISDR, STOI
from ..runtime.device import resolve_device
from ._common import add_device, markdown_row, numeric_means, onnx_device, write_csv


def build_metrics(names, sr, device_index: int = -1):
    metrics = {}
    for n in names:
        if n == "si_sdr":
            metrics[n] = SISDR()
        elif n == "stoi":
            metrics[n] = STOI(sr=sr)
        elif n == "dnsmos":
            from ..metrics import DNSMOS

            metrics[n] = DNSMOS(input_sr=sr, device=device_index)
        elif n == "pesq_wb":
            from ..metrics import PESQ

            metrics[n] = PESQ(sr=sr, mode="wb")
        else:
            raise ValueError(f"Unknown metric {n}")
    return metrics


def score_pair(job):
    est_path, ref_path, names, sr, device_index = job
    est = load_wav(est_path, sr=sr)
    row = {"file": Path(est_path).name}
    for n, m in build_metrics(names, sr, device_index).items():
        if n == "dnsmos":
            row |= m(est)
        else:
            ref = load_wav(ref_path, sr=sr)
            t = min(len(est), len(ref))
            row |= m(est[:t], ref[:t])
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-E", "--estimated", required=True, help="dir or scp of estimated wavs")
    p.add_argument("-R", "--reference", required=True, help="dir or scp of reference wavs")
    p.add_argument("-M", "--metrics", nargs="+", default=["si_sdr", "stoi"])
    p.add_argument("-O", "--output", default="metrics.csv")
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--num_workers", type=int, default=8)
    add_device(p)
    args = p.parse_args(argv)
    index = onnx_device(resolve_device(args.device))

    est_files = sorted(find_files(args.estimated))
    ref_files = sorted(find_files(args.reference))
    if len(est_files) != len(ref_files):
        raise ValueError(f"count mismatch: {len(est_files)} est vs {len(ref_files)} ref")

    jobs = [(e, r, args.metrics, args.sr, index) for e, r in zip(est_files, ref_files)]
    if args.num_workers > 1:
        with ProcessPoolExecutor(max_workers=args.num_workers,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            rows = list(pool.map(score_pair, jobs))
    else:
        rows = [score_pair(j) for j in jobs]

    write_csv(rows, args.output)
    means = numeric_means(rows)
    print(markdown_row(means))
    print(f"\nWrote {len(rows)} rows to {args.output}")
    return means


if __name__ == "__main__":
    main()
