"""A copy of the benchmark in a temporary directory with tiny cells added as
new files and entries, for CPU runs of the harness."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_MODEL = dict(n_fft=64, hop_length=16, win_length=64, fdrc=0.5, fb_input_size=8,
                  fb_hidden_size=12, fb_num_layers=2, fb_proj_size=8,
                  fb_output_activate_function=False, sb_hidden_size=10, sb_num_layers=2,
                  freq_cutoffs=[0, 8, 16, 32], df_orders=[3, 2, 1], center_freq_sizes=[2, 4, 8],
                  neighbor_freq_sizes=[2, 2, 2], use_pre_layer_norm_fb=True,
                  use_pre_layer_norm_sb=True, bn=True, shared_weights=True, sequence_model="GSN",
                  num_spks=1, scan_mode="fused")

TINY_CONFIG = {
    "source": "a tiny stand-in for tests", "factory": "build", "model_args": TINY_MODEL,
    "weights": {"kind": "seeded"},
    "serve": {"compute_dtype": None, "scan_mode": "auto", "collect_layer_outputs": False},
}

TRAFFIC = {"mode": "serve", "generator": "tones", "batch": 3, "seconds": 0.15,
           "sample_rate": 16000, "pool": 2, "f0_hz": [120.0, 800.0], "mod_hz": [1.0, 4.0],
           "snr_db": [-5.0, 20.0], "check_rows": 2}

# the prefix covers the first 512 of 2400 samples; the whole-clip numbers
# the rest
CHECKS = {"limits": {"enh_prefix_err": 1e-4, "enh_wave_err": 1e-3, "enh_segment_rms_err": 1e-2},
          "prefix_samples": 512, "segment_samples": 400}


def tiny_root(tmp: Path) -> Path:
    """The benchmark copied to ``tmp`` with the cell ``tiny.serve`` added as
    new files and new entries only."""
    root = Path(tmp) / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(REPO / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    bench = root / "gpubench"
    (bench / "configs" / "tiny.json").write_text(json.dumps(TINY_CONFIG))
    (bench / "traffic" / "tiny_serve.json").write_text(json.dumps(TRAFFIC))
    (bench / "cells" / "tiny.serve.json").write_text(json.dumps(CHECKS))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny", "source": "tests", "file": "gpubench/configs/tiny.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "tiny.serve", "config": "tiny", "traffic": "tiny_serve",
                              "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.serve")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
