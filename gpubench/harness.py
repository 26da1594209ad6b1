"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

Everything a cell needs is found by name:
- ``BENCHMARK.json``: the cell (configuration, traffic, chips), its
  end-to-end metrics and its per-layer metrics;
- ``<bench>/configs/<config>.json``: the model arguments as published, how
  the weights are made, and the run options of each mode;
- ``<bench>/traffic/<traffic>.json``: the mix, made by the generator it
  names (``traffic.py``, ``generators/<generator>.py``);
- ``<bench>/runners/<mode>.py``: what runs the mix's ``mode``,
  ``run(cell, seed, seconds, trace, device, fault) -> dict``;
- ``<bench>/cells/<cell>.json``: the numbers compared, their limits and
  parameters (``check.py``);
- ``<bench>/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx) -> float | None``.
So a cell, a configuration, a mix, a mode or a metric is added by adding
files and entries, never by editing this module.

The program under test is the package ``spiking_fullsubnet_torch``; it is
imported inside the runners, and the reference (``reference.py``) never
imports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from . import check, reference, traffic, weights, work
from .trace import reduce as reduce_trace

FORBIDDEN = ("jax", "jaxlib", "flax", "spiking_fullsubnet_tpu")
# precision a configuration states -> the reference's control arithmetic
CONTROLS = {"float32": reference.Ops(quant="tf32")}


class Cell:
    """A cell of ``BENCHMARK.json`` with the files it names."""

    def __init__(self, root: Path, name: str):
        self.root, self.name = Path(root), name
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.bench = self.root / self.spec["paths"][0]
        found = [w for w in self.spec["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        entry = [c for c in self.spec["configs"] if c["name"] == self.workload["config"]][0]
        self.config = json.loads((self.root / entry["file"]).read_text())
        self.geom = reference.geometry(self.config["factory"], self.config["model_args"])
        self.traffic = traffic.load(self.bench / "traffic" / f"{self.workload['traffic']}.json")
        self.mode = self.traffic["mode"]
        self.check = json.loads((self.bench / "cells" / f"{name}.json").read_text())
        self.limits = self.check["limits"]
        self.chips = self.workload["chips"]

        def mine(m):
            return name in m["workloads"] if "workloads" in m else True

        self.end_to_end = [m for m in self.spec["end_to_end"] if mine(m)]
        e2e_names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.spec["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e_names)]

    @property
    def precision(self) -> str:
        return self.config[self.mode].get("compute_dtype") or "float32"

    def runner(self):
        return importlib.import_module(f"{__package__}.runners.{self.mode}")

    def reader(self, metric: str) -> Callable[[Dict[str, Any]], Optional[float]]:
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric.replace('.', '_')}",
                                                      path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_config(cell: Cell, mode: str):
    """The program's configuration: the published model arguments with the
    mode's run options."""
    from spiking_fullsubnet_torch.models import spiking_fullsubnet as sfs

    args = dict(cell.config["model_args"])
    if cell.config["factory"] == "build":
        args = {k: (tuple(v) if isinstance(v, list) else
                    None if k.endswith("activate_function") and v is False else v)
                for k, v in args.items()}
        cfg = sfs.SpikingFullSubNetConfig(**args)
    else:
        cfg = sfs.separator_config(**args)
    opts = {k: v for k, v in cell.config[mode].items()
            if k in ("scan_mode", "compute_dtype", "collect_layer_outputs")}
    return dataclasses.replace(cfg, **opts)


def make_weights(cell: Cell, seed: int, device: torch.device):
    w = cell.config["weights"]
    if w["kind"] == "seeded":
        return weights.seeded(cell.geom, seed, device)
    return weights.from_npz(cell.root / w["file"], device)


def profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


# ---------------------------------------------------------------- a run


def card_line(device: torch.device) -> str:
    """The card's name and power limit, from ``nvidia-smi``."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        smi = res.stdout.strip().splitlines()[device.index or 0] if res.returncode == 0 else "?"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        smi = "nvidia-smi unavailable"
    return f"# card: {torch.cuda.get_device_name(device)}; nvidia-smi name, power.limit: {smi}"


def forbidden_modules() -> List[str]:
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def run(root: Path, name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: Optional[torch.device] = None, fault: Optional[str] = None,
        emit: Callable[[str], None] = print) -> Dict[str, Any]:
    """Run a cell once and return its result line's object (also printed
    through ``emit`` as the last line). ``device`` None looks for the cards
    the cell asks for and raises ``SystemExit`` without them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = Cell(root, name)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{name} needs {cell.chips} CUDA device(s); "
                             f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        import spiking_fullsubnet_torch

        if not Path(spiking_fullsubnet_torch.__file__).resolve().is_relative_to(Path(root).resolve()):
            raise SystemExit(f"the program under test is not in this checkout ({root}): "
                             f"{spiking_fullsubnet_torch.__file__}")
        device = torch.device("cuda", 0)
        emit(card_line(device))
        from spiking_fullsubnet_torch.ops import gsu_kernels
        from spiking_fullsubnet_torch.runtime.cache import enable_compilation_cache

        enable_compilation_cache(root / "spiking_fullsubnet_torch" / "_build")
        gsu_kernels.build_kernels()
        torch.cuda.reset_peak_memory_stats(device)
    res = cell.runner().run(cell, seed, seconds, trace, device, fault)
    setup_s = res["t_window"] - t_start
    line: Dict[str, Any] = {"correct": False, "attempted": res["units"], "failed": 0}
    if trace:
        red = reduce_trace(res["prof"]) if res["prof"] is not None else {
            "kernels": [], "busy_s": 0.0, "breakdown": {"device_ops": [], "idle_gaps": []}}
        ctx = {"cell": name, "mode": cell.mode, "geom": cell.geom, "config": cell.config,
               "traffic": cell.traffic, "chips": cell.chips, "units": res["units"],
               "shapes": res["shapes"], "window_s": res["window_s"], "audio_s_per_s": res["audio_s_per_s"],
               "kernels": red["kernels"], "busy_s": red["busy_s"], "work": work}
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = dict(res["e2e"], setup_s=setup_s)
        metrics = {m["name"]: {"value": vals[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    res.pop("prof", None)
    numbers = res["compare"](res["answers"], res["reference"](reference.PLAIN))
    checks = check.judge(numbers, cell.limits)
    line["correct"] = check.passed(checks)
    line["metrics"] = metrics
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    line["device"] = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
                      "count": cell.chips, "memory_peak_bytes": int(res["peak"])}
    if trace:
        line["device"].update(busy_s=red["busy_s"], window_s=res["window_s"])
        line["breakdown"] = red["breakdown"]
    line["checks"] = checks
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"modules of JAX or the JAX package loaded in this process: {bad}")
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    emit(json.dumps(line))
    return line


def main(argv: List[str], t_start: float, root: Path) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    torch.set_num_threads(4)
    run(root, a.workload, a.seed, a.seconds, bool(a.trace), t_start)
    return 0
