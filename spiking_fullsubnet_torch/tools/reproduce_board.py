"""One-command Intel N-DNS leaderboard row (counterpart of
``tools/reproduce_board.py``):

    python -m spiking_fullsubnet_torch.tools.reproduce_board \\
        --dns_root /datasets/intel_ndns/validation_set \\
        --size m --torch_ckpt /path/to/pytorch_model.bin \\
        --out exp/board [--device cuda|cpu]

1. Dataset gate: without ``noisy/*.wav`` under the root it prints why and
   returns 2, so it can stand in a pipeline before the data is mounted.
2. Writes a test TOML from ``recipes/intel_ndns/spiking_fullsubnet/
   baseline_<size>.toml`` with ``[test_dataset]`` on the root (batch 1, the
   whole utterances) and runs the port's recipe CLI on it in this process
   (``runtime.cli -M test`` with ``--torch_ckpt`` or ``--ckpt_path``, on
   ``--device``: the forward's kernels on the card).
3. Folds the per-utterance metrics CSV that the trainer wrote (SI-SDR,
   DNSMOS where onnxruntime imports, synops) into one row: synops a frame
   times fs / hop is ``power_proxy_Ops/s``, times the total latency
   ``PDP_proxy_Ops``; the parameters are counted on the tested model.
4. Writes the row as YAML and markdown through ``metricsboard_writeout``
   (SI-SNRi against the challenge's noisy baseline).
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import sys
from pathlib import Path

from ..runtime.config import toml_dump, toml_load
from ..runtime.convert import flat_paths
from ..runtime.device import resolve_device
from ._common import add_device
from .metricsboard_writeout import complete_entry, to_markdown, to_yaml

REPO = Path(__file__).resolve().parents[2]
RECIPE = REPO / "recipes" / "intel_ndns" / "spiking_fullsubnet"

LATENCY_ENC_DEC_MS = 0.036  # the challenge's encoder and decoder accounting (BASELINE.md)


def dataset_present(root: str) -> bool:
    return bool(glob.glob(str(Path(root) / "noisy" / "*.wav")))


def build_config(size: str, dns_root: str, out_dir: Path, limit=None) -> Path:
    """The test config, from the recipe's baseline TOML of ``size``. Its
    ``[trainer] path`` stays the recipe's: the CLI maps it by the recipe
    directory (``cli.RECIPE_TRAINERS``)."""
    base = RECIPE / f"baseline_{size}.toml"
    if not base.exists():
        base = RECIPE / "baseline_m.toml"
    cfg = toml_load(base)
    cfg["meta"]["save_dir"] = str(out_dir)
    cfg["test_dataset"]["args"] = {"root": dns_root, "train": False,
                                   **({"limit": limit} if limit else {})}
    cfg["test_dataset"]["dataloader"] = {"batch_size": 1, "num_workers": 0}
    out_path = out_dir / f"board_{size}.toml"
    out_path.parent.mkdir(parents=True, exist_ok=True)
    toml_dump(cfg, out_path)
    return out_path


def collect_row(metrics_dir: Path, model_name: str, params_count: int,
                sr: int = 16000, hop: int = 128) -> dict:
    """The trainer's mean test CSV as one leaderboard entry."""
    csvs = sorted(metrics_dir.glob("dl_0_*_mean.csv"))
    if not csvs:
        raise FileNotFoundError(f"no metrics CSVs under {metrics_dir}")
    with open(csvs[-1], newline="") as f:
        mean = next(csv.DictReader(f))
    entry = {
        "team": "spiking_fullsubnet_torch",
        "model": model_name,
        "SI-SNR": round(float(mean["si_sdr"]), 4),
        "latency_enc+dec_ms": LATENCY_ENC_DEC_MS,
        "latency_total_ms": round(hop / sr * 1e3 + LATENCY_ENC_DEC_MS, 3),
    }
    for k, col in [("OVRL", "MOS_ovrl"), ("SIG", "MOS_sig"), ("BAK", "MOS_bak")]:
        if mean.get(k):
            entry[col] = round(float(mean[k]), 4)
    if mean.get("synops"):
        power = float(mean["synops"]) * sr / hop  # ops a frame -> ops a second
        entry["power_proxy_Ops/s"] = round(power, 1)
        entry["PDP_proxy_Ops"] = round(power * entry["latency_total_ms"] / 1e3, 1)
    if params_count:
        entry["params"] = int(params_count)
        entry["size_kilobytes"] = int(params_count * 4 / 1024)
    return entry


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dns_root", required=True, help="N-DNS set root (noisy/ clean/)")
    p.add_argument("--size", default="m", choices=["s", "m", "l", "xl"])
    p.add_argument("--torch_ckpt", default=None, help="reference pytorch_model.bin")
    p.add_argument("--ckpt_path", default=None, help="the experiment's checkpoint "
                                                     "(best, latest, init or a path)")
    p.add_argument("--out", default="exp/board", help="output directory")
    p.add_argument("--limit", type=int, default=None, help="cap utterance count")
    p.add_argument("--entry_name", default=None)
    add_device(p)
    args = p.parse_args(argv)

    if not dataset_present(args.dns_root):
        print(f"[reproduce_board] no dataset at {args.dns_root} "
              f"(expected noisy/*.wav) — skipping cleanly.", file=sys.stderr)
        return 2
    resolve_device(args.device)  # fail before writing anything

    from ..runtime.cli import main as cli_main

    out_dir = Path(args.out).absolute()
    cfg_path = build_config(args.size, args.dns_root, out_dir, limit=args.limit)
    cli_argv = ["-C", str(cfg_path), "-M", "test", "--device", args.device]
    if args.torch_ckpt:
        cli_argv += ["--torch_ckpt", args.torch_ckpt]
    if args.ckpt_path:
        cli_argv += ["--ckpt_path", args.ckpt_path]
    trainer = cli_main(cli_argv, recipe_dir=RECIPE)

    cfg = toml_load(cfg_path)
    metrics_dir = out_dir / cfg_path.stem / "metrics"
    name = args.entry_name or f"spiking_fullsubnet_{args.size.upper()}"
    # latency and ops a second follow the hop and sample rate that ran
    model_args = cfg["model"]["args"]
    sr = int(cfg.get("acoustics", {}).get("sr", 16000))
    hop = int(model_args.get("hop_length", cfg.get("acoustics", {}).get("hop_length", 128)))
    params_count = sum(t.numel() for t in flat_paths(trainer.params).values())
    entry = complete_entry(collect_row(metrics_dir, name, params_count, sr=sr, hop=hop))
    (out_dir / "metricsboard_validation.yml").write_text(to_yaml([entry]))
    (out_dir / "metricsboard_validation.md").write_text(to_markdown([entry]))
    print(json.dumps(entry))
    print(f"[reproduce_board] wrote {out_dir}/metricsboard_validation.{{yml,md}}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
