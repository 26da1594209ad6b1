"""Golden metric vectors from the real metric backends (counterpart of
``tools/validate_metric_backends.py``):

    python -m spiking_fullsubnet_torch.tools.validate_metric_backends [--output FILE] \
        [--device cuda|cpu]

Seeded speech-like (clean, degraded) pairs are scored with each backend
that imports (pystoi, the ITU ``pesq`` wheel, onnxruntime with the bundled
DNSMOS graphs on ``--device``) and written to ``--output`` (default
``tests/fixtures/metric_backends_golden.json``, which
``tests/test_metric_backend_fixtures.py`` reads); the port's own STOI and
PESQ are printed against them. A backend that does not import is skipped.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..metrics.dnsmos import DNSMOS
from ..metrics.metrics import PESQ as OurPESQ
from ..metrics.metrics import stoi as our_stoi
from ..runtime.device import resolve_device
from ._common import add_device, onnx_device

REPO = Path(__file__).resolve().parents[2]
FIXTURE = REPO / "tests" / "fixtures" / "metric_backends_golden.json"
SR = 16000


def fixture_signals(n_pairs: int = 4, seconds: float = 4.0, seed: int = 17):
    """Deterministic (clean, degraded) pairs. Uses only numpy Generator
    ops with stable cross-platform streams."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * SR)) / SR
    pairs = []
    for i in range(n_pairs):
        f0 = rng.uniform(90, 220) + rng.uniform(10, 40) * np.sin(
            2 * np.pi * rng.uniform(1, 4) * t)
        phase = 2 * np.pi * np.cumsum(f0) / SR
        sig = sum(np.sin(k * phase) / k for k in range(1, 9))
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6)))
        clean = (0.2 * env * sig).astype(np.float64)
        snr_noise = rng.uniform(0.02, 0.12)
        degraded = clean + snr_noise * rng.standard_normal(len(t))
        pairs.append((clean, degraded.astype(np.float64)))
    return pairs


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--output", default=str(FIXTURE))
    add_device(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    out = Path(args.output)
    pairs = fixture_signals()
    golden = {"sr": SR, "n_pairs": len(pairs), "generator": "fixture_signals(seed=17)"}

    # ---- pystoi ----
    try:
        from pystoi import stoi as pystoi_stoi

        vals, evals, ours, eours = [], [], [], []
        for clean, deg in pairs:
            vals.append(float(pystoi_stoi(clean, deg, SR, extended=False)))
            evals.append(float(pystoi_stoi(clean, deg, SR, extended=True)))
            ours.append(float(our_stoi(clean, deg, SR, extended=False)))
            eours.append(float(our_stoi(clean, deg, SR, extended=True)))
        golden["pystoi"] = {"stoi": vals, "estoi": evals}
        d = max(abs(a - b) for a, b in zip(vals + evals, ours + eours))
        print(f"pystoi: golden written; in-tree STOI max|delta| = {d:.6f}")
    except ImportError:
        print("pystoi not installed — skipping STOI golden")

    # ---- ITU pesq wheel ----
    try:
        from pesq import pesq as itu_pesq

        wb, nb, ours_wb = [], [], []
        for clean, deg in pairs:
            wb.append(float(itu_pesq(SR, clean, deg, "wb")))
            nb.append(float(itu_pesq(8000, clean[::2], deg[::2], "nb")))
            ours_wb.append(OurPESQ(sr=SR, mode="wb", backend="numpy")(deg, clean)["pesq_wb"])
        golden["pesq"] = {"wb": wb, "nb": nb}
        d = max(abs(a - b) for a, b in zip(wb, ours_wb))
        print(f"pesq: golden written; in-tree reconstruction max|delta| = {d:.4f} MOS")
    except ImportError:
        print("pesq wheel not installed — skipping PESQ golden")

    # ---- onnxruntime + bundled DNSMOS graphs ----
    try:
        import onnxruntime  # noqa: F401

        scorer = DNSMOS(input_sr=SR, device=onnx_device(dev))
        rows = []
        for clean, deg in pairs:
            rows.append({k: float(v) for k, v in
                         scorer(deg.astype(np.float32)).items()})
        golden["dnsmos"] = rows
        print(f"onnxruntime: DNSMOS golden written ({len(rows)} rows) — the "
              "in-tree protocol executed the real runtime end-to-end")
    except ImportError:
        print("onnxruntime not installed — skipping DNSMOS golden")

    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(golden, indent=2))
    print(f"wrote {out}")
    print("commit the fixture to make tests/test_metric_backend_fixtures.py "
          "validate the in-tree metrics against these goldens permanently")
    return golden


if __name__ == "__main__":
    main()
