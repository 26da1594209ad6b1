"""Intel N-DNS challenge leaderboard writer (the port's copy of the
package-neutral ``tools/metricsboard_writeout.py``): a JSON list of model
entries to the challenge leaderboard as YAML and markdown, with the SI-SNRi
deltas against the noisy baselines:

    python -m spiking_fullsubnet_torch.tools.metricsboard_writeout -I entries.json \
        [-O metricsboard_track_1] [--subtract_noisy_mos]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

INTEL_NOISY = {"SI-SNR": 7.62, "MOS_ovrl": 2.45, "MOS_sig": 3.19, "MOS_bak": 2.72}
CUSTOM_NOISY = {"SI-SNR": 6.89, "MOS_ovrl": 2.40, "MOS_sig": 3.10, "MOS_bak": 2.66}

COLUMNS = [
    "team",
    "model",
    "date",
    "SI-SNR",
    "SI-SNRi_data",
    "SI-SNRi_enc+dec",
    "MOS_ovrl",
    "MOS_sig",
    "MOS_bak",
    "latency_enc+dec_ms",
    "latency_total_ms",
    "power_proxy_Ops/s",
    "PDP_proxy_Ops",
    "params",
    "size_kilobytes",
    "model_path",
]


def complete_entry(e: dict, noisy=CUSTOM_NOISY, subtract_mos: bool = False) -> dict:
    out = dict(e)
    if out.get("SI-SNR") is not None and "SI-SNRi_data" not in out:
        out["SI-SNRi_data"] = round(out["SI-SNR"] - noisy["SI-SNR"], 4)
        out["SI-SNRi_enc+dec"] = out["SI-SNRi_data"]
    if subtract_mos:
        for k, nk in [("MOS_ovrl", "MOS_ovrl"), ("MOS_sig", "MOS_sig"), ("MOS_bak", "MOS_bak")]:
            if k in out and out[k] is not None:
                out[k] = round(out[k] - noisy[nk], 4)
    for c in COLUMNS:
        out.setdefault(c, None)
    return out


def to_markdown(entries) -> str:
    head = "| " + " | ".join(COLUMNS) + " |"
    sep = "|" + "|".join(["---"] * len(COLUMNS)) + "|"
    rows = []
    for e in entries:
        rows.append("| " + " | ".join("" if e[c] is None else str(e[c]) for c in COLUMNS) + " |")
    return "\n".join([head, sep] + rows) + "\n"


def to_yaml(entries) -> str:
    # minimal YAML emitter (list of flat dicts) — avoids a yaml dependency
    lines = []
    for e in entries:
        first = True
        for c in COLUMNS:
            v = e[c]
            prefix = "- " if first else "  "
            first = False
            if v is None:
                lines.append(f"{prefix}{c}: null")
            elif isinstance(v, str):
                lines.append(f"{prefix}{c}: '{v}'")
            else:
                lines.append(f"{prefix}{c}: {v}")
    return "\n".join(lines) + "\n"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-I", "--entries_json", required=True, help="JSON list of entry dicts")
    p.add_argument("-O", "--output_stem", default="metricsboard_track_1")
    p.add_argument("--subtract_noisy_mos", action="store_true", help="store MOS as delta vs noisy")
    args = p.parse_args(argv)

    entries = json.loads(Path(args.entries_json).read_text())
    entries = [complete_entry(e, subtract_mos=args.subtract_noisy_mos) for e in entries]
    entries.sort(key=lambda e: (e["SI-SNR"] is not None, e["SI-SNR"]), reverse=True)

    Path(f"{args.output_stem}.md").write_text(to_markdown(entries))
    Path(f"{args.output_stem}.yml").write_text(to_yaml(entries))
    print(f"Wrote {args.output_stem}.md / .yml with {len(entries)} entries")


if __name__ == "__main__":
    main()
