#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line last.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Caches go to fixed directories inside the
checkout: the kernels' libraries to ``spiking_fullsubnet_torch/_build``,
PyTorch's and CUDA's own kernel caches to ``gpubench/_cache``.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
os.environ["TORCH_KERNEL_CACHE_PATH"] = str(HERE / "_cache" / "torch_kernels")
os.environ["CUDA_CACHE_PATH"] = str(HERE / "_cache" / "cuda")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

from gpubench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START, ROOT))
