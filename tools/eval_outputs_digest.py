#!/usr/bin/env python3
"""Digests of the untraced eval outputs of kernels A, B and F on one GPU, so
that two checkouts of the port can be compared bit for bit:

    python3 tools/eval_outputs_digest.py --root DIR --out FILE.json
    python3 tools/eval_outputs_digest.py --compare FILE_A.json FILE_B.json

``--root`` names the checkout whose ``spiking_fullsubnet_torch`` is imported
(its kernels are built there at first use). On zoo M
(``model_zoo/intel_ndns/spike_fsb/baseline_m.npz``, offline laplace norm) at
16 x 6 s of float32 noise from seed 18 it runs, with no tracer open:

- the layered forward (kernel F, one launch a stack): the enhanced signal
  and every layer's output of the fullband and of each section;
- the serving forward (``scan_mode="auto"``, ``collect_layer_outputs=False``:
  kernels A and B): the enhanced signal and magnitude;
- the collect path (``scan_mode="auto"``: kernel A a stack, every layer
  out): the enhanced signal and every layer's output;
- A and F called directly on bf16 streams from seed 18 (A in its 3-D and
  units forms, every layer out).

Each output's digest is its shape, type and the SHA-256 of its bytes.
``--compare`` prints one JSON object (outputs, equal, the names that
differ) and exits 1 unless every output of both files is equal.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

SEED, B, SECONDS, SR = 18, 16, 6.0, 16000


def digest(t) -> list:
    import torch

    a = t.detach().contiguous().cpu().reshape(-1)
    h = hashlib.sha256()
    for i in range(0, a.numel(), 1 << 26):
        h.update(a[i:i + (1 << 26)].view(torch.uint8).numpy().tobytes())
    return [list(t.shape), str(t.dtype), h.hexdigest()]


def run(root: Path) -> dict:
    sys.path.insert(0, str(root.resolve()))
    import torch

    from spiking_fullsubnet_torch.models.spiking_fullsubnet import (
        SpikingFullSubNet, separator_config, spiking_fullsubnet_apply)
    from spiking_fullsubnet_torch.ops import gsu_kernels as gk

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    out, launches = {}, {}
    wrappers = {"A": gk.gsu_stack_eval, "B": gk.gsu_sections_eval, "F": gk.gsu_stack_eval_x}

    def counted(name, fn):
        for w in wrappers.values():
            w.launches = 0
        res = fn()
        torch.cuda.synchronize()
        launches[name] = {k: w.launches for k, w in wrappers.items()}
        return res

    def keep(prefix, res):
        out[f"{prefix}/enhanced_y"] = digest(res["enhanced_y"])
        if res.get("enhanced_mag") is not None:
            out[f"{prefix}/enhanced_mag"] = digest(res["enhanced_mag"])
        for i, t in enumerate(res.get("fb_all_layer_outputs") or []):
            out[f"{prefix}/fb{i}"] = digest(t)
        for s, lst in enumerate(res.get("sb_all_layer_outputs") or []):
            for i, t in enumerate(lst):
                out[f"{prefix}/sb{s}.{i}"] = digest(t)

    zoo = root / "model_zoo" / "intel_ndns" / "spike_fsb" / "baseline_m.npz"
    cfg = separator_config(norm_type="offline_laplace_norm", shared_weights=True, bn=True)
    model = SpikingFullSubNet.from_npz(str(zoo), cfg, device=dev)
    p, st = model.param_tree(), model.state_tree()
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy((0.1 * rng.standard_normal((B, int(SECONDS * SR)))).astype(
        np.float32)).to(dev)
    for name, kw in [("layered", {}),
                     ("serving", dict(scan_mode="auto", collect_layer_outputs=False)),
                     ("collect", dict(scan_mode="auto"))]:
        c = dataclasses.replace(cfg, **kw)
        keep(name, counted(name, lambda: spiking_fullsubnet_apply(c, p, st, x)))

    g = torch.Generator().manual_seed(SEED)
    io, H, L = torch.bfloat16, 224, 2
    T = int(SECONDS * SR) // 128 + 1  # the frames of the layered forward
    layers = [{"weight_ih": torch.randn(H, H if k else 38, generator=g) / 6,
               "weight_hh": torch.randn(H, H, generator=g) / H ** 0.5,
               "bias_ih": torch.randn(2 * H, generator=g) * 0.1} for k in range(L)]
    states = [{} for _ in range(L)]
    wx = [t.to(dev) for t in gk.pack_stack_x(layers, states, H, io)]
    xf = torch.rand(T, 2048, 38, generator=g).to(io).to(dev)
    out["direct/F_bf16"] = digest(counted("direct F", lambda: gk.gsu_stack_eval_x(xf, *wx, H,
                                                                                  True)))
    wa = [t.to(dev) for t in gk.pack_stack(layers, states, H, io)]
    for form, shape in [("3d", (T, 256, H)), ("units", (8, T, 256, H))]:
        xg = (torch.randn(shape, generator=g) * 0.5).to(io).to(dev)
        out[f"direct/A_bf16_{form}"] = digest(counted(
            f"direct A {form}", lambda: gk.gsu_stack_eval(xg, *wa, H, True, collect_all=True)))
    return {"root": str(root), "package": str(Path(gk.__file__).resolve().parents[1]),
            "launches": launches, "outputs": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--compare", nargs=2, type=Path)
    args = ap.parse_args()
    if args.compare:
        a, b = (json.loads(f.read_text())["outputs"] for f in args.compare)
        differ = sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))
        print(json.dumps({"outputs": len(a), "equal": len(a) - len(differ) if a.keys() == b.keys()
                          else None, "differ": differ}))
        return 0 if not differ else 1
    import torch

    if not torch.cuda.is_available():
        print("eval_outputs_digest: no CUDA device", file=sys.stderr)
        return 2
    rec = run(args.root)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(rec, indent=1))
    print(json.dumps({"package": rec["package"], "outputs": len(rec["outputs"]),
                      "launches": rec["launches"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
