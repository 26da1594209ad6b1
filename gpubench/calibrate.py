#!/usr/bin/env python3
"""The readings the limits of ``cells/<cell>.json`` are set from, on the
card, at the cell's own size, in one process:

- the program's numbers on each of ``--seeds`` (each pool batch once);
- on ``--control-seeds``, the control's: the reference computed in the
  nearest precision below the configuration's (TF32 for float32) in the
  program's place;
- on the same seeds, each of ``--faults`` planted in the timed path
  (``runners/<mode>.FAULTS``).

Each record has every number of ``check.NUMBERS`` at the cell's parameters
and, under ``sweep``, at other prefixes and segment lengths.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1-12 --control-seeds 1-3 \\
        [--faults late_zero,state_reset] [--out calibrate.jsonl]

One JSON line a seed and kind; the benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
os.environ["TORCH_KERNEL_CACHE_PATH"] = str(HERE / "_cache" / "torch_kernels")
os.environ["CUDA_CACHE_PATH"] = str(HERE / "_cache" / "cuda")
sys.path.insert(0, str(ROOT))


def seeds(text: str):
    out = []
    for part in filter(None, text.split(",")):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    import torch

    from gpubench import check, harness, reference

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--offset", type=int, default=0, help="added to every seed")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.Cell(ROOT, a.workload)
    device = torch.device("cuda", 0)
    print(harness.card_line(device), flush=True)
    from spiking_fullsubnet_torch.ops import gsu_kernels
    from spiking_fullsubnet_torch.runtime.cache import enable_compilation_cache

    enable_compilation_cache(ROOT / "spiking_fullsubnet_torch" / "_build")
    gsu_kernels.build_kernels()
    runner = cell.runner()
    control = harness.CONTROLS[cell.precision]
    faults = [f for f in a.faults.split(",") if f]
    sink = open(a.out, "a") if a.out else None
    params = dict({"prefix_samples": 256, "segment_samples": 16000}, **cell.check)

    def numbers(prog, ref):
        out = {k: f(prog, ref, params) for k, f in check.NUMBERS.items()}
        sweep = {f"prefix_{n}": check.prefix_err(prog, ref, {"prefix_samples": n})
                 for n in (128, 256, 512, 1024, 2048, 4096, 8192, 32768, 65536, 160000)}
        sweep.update({f"segment_rms_{n}": check.segment_rms_err(prog, ref, {"segment_samples": n})
                      for n in (4000, 16000, 48000, 160000)})
        return dict(out, sweep=sweep)

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    for s in a.seeds:
        seed = s + a.offset
        t0 = time.perf_counter()
        res = runner.run(cell, seed, 0, False, device)
        t1 = time.perf_counter()
        ref = res["reference"](reference.PLAIN)
        t2 = time.perf_counter()
        emit({"cell": a.workload, "seed": seed, "kind": "program",
              "numbers": numbers(res["answers"], ref),
              "program_s": t1 - t0, "reference_s": t2 - t1})
        if s in a.control_seeds:
            emit({"cell": a.workload, "seed": seed, "kind": "control",
                  "numbers": numbers(res["reference"](control), ref)})
            for f in faults:
                try:
                    bad = runner.run(cell, seed, 0, False, device, fault=f)
                    emit({"cell": a.workload, "seed": seed, "kind": f"fault:{f}",
                          "numbers": numbers(bad["answers"], ref)})
                    del bad
                except Exception as e:  # a fault that crashes reads nothing
                    emit({"cell": a.workload, "seed": seed, "kind": f"fault:{f}",
                          "error": repr(e)[:500]})
        del res, ref
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
