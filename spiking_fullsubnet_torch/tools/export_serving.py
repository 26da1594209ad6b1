"""Serving export: the enhancement graphs as ``torch.export`` artifacts
(counterpart of ``tools/export_serving.py``).

Writes, with the weights baked in as constants:
  - the offline batched enhance graph  (``enhance_bBATCH_tSAMPLES.pt2``)
  - the streaming per-chunk step       (``streaming_step_bBATCH_cfCHUNK.pt2``)
    and its initial state (``streaming_init_state_bBATCH.npz``, one array a
    leaf, keyed by its ``/``-joined path)
plus a ``manifest.json`` of shapes, dtypes, sample rate and device, and a
``--check`` mode that loads each artifact with ``torch.export.load``, runs
it and holds it against the live graph at atol 0. A serving process needs
``torch.export.load`` and ``.module()`` and no model code, but an artifact
exported on the card calls the port's kernels as operators
(``sfs_torch::*``): import ``spiking_fullsubnet_torch.ops.gsu_kernels``
before loading it (the manifest's ``requires``).

On the card the offline graph reaches kernel C (``--scan_mode auto``, the
flagship preset's pre-LN monolith) or kernel F (``fused``, the default: the
layered formulation, four launches); on the CPU the kernels' plain versions.
The streaming step is plain PyTorch operations on either.

Usage:
  python -m spiking_fullsubnet_torch.tools.export_serving -O exported/
      [--npz model_zoo/.../baseline_m.npz] [--what offline streaming]
      [--batch 1] [--chunk_frames 1] [--seconds 30] [--sr 16000]
      [--scan_mode fused] [--device cuda|cpu] [--check]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..runtime.convert import flat_paths, load_npz
from ..streaming import StreamingEnhancer, state_leaves, state_paths

REQUIRES = "spiking_fullsubnet_torch.ops.gsu_kernels"


def build_bundle(npz_path=None, device=None, **overrides):
    """The flagship preset (``models/presets.flagship_m``) on ``device``,
    with the weights of a framework ``.npz`` when one is given."""
    from ..models.presets import flagship_m

    bundle = flagship_m(device=device, **overrides)
    if npz_path:
        tree = load_npz(npz_path, device=device)
        for part in ("params", "state"):
            want = {k: tuple(v.shape) for k, v in flat_paths(bundle[part]).items()}
            got = {k: tuple(v.shape) for k, v in flat_paths(tree[part]).items()}
            if want != got:
                raise ValueError(f"{npz_path}: its {part} do not fit the model "
                                 f"({sorted(set(want.items()) ^ set(got.items()))[:4]} ...)")
        bundle["params"], bundle["state"] = tree["params"], tree["state"]
    return bundle


class _Enhance(torch.nn.Module):
    """The eval forward, ``noisy [B, T] -> enhanced [B, T]``."""

    def __init__(self, bundle):
        super().__init__()
        self.bundle = bundle

    def forward(self, noisy):
        b = self.bundle
        return b["apply"](b["config"], b["params"], b["state"], noisy, train=False)["enhanced_y"]


class _Step(torch.nn.Module):
    """The streaming chunk step, ``(state, chunk) -> (new state, enhanced)``."""

    def __init__(self, enhancer: StreamingEnhancer):
        super().__init__()
        self.enhancer = enhancer

    def forward(self, state, chunk):
        return self.enhancer.eager_step(state, chunk)


def export_offline(bundle, batch: int, seconds: float, sr: int):
    """``torch.export`` of the eval forward at ``[batch, seconds * sr]``
    float32 on the weights' device: (the exported program, the example)."""
    dev = bundle["params"]["fb"]["proj"]["weight"].device
    example = torch.zeros(batch, int(seconds * sr), dtype=torch.float32, device=dev)
    with torch.no_grad():
        exported = torch.export.export(_Enhance(bundle), (example,))
    return exported, example


def export_streaming(bundle, batch: int, chunk_frames: int):
    """``torch.export`` of the streaming chunk step over ``(state, chunk)``:
    (the exported program, the enhancer, its initial state, a zero chunk)."""
    cfg = bundle["config"]
    dev = bundle["params"]["fb"]["proj"]["weight"].device
    enhancer = StreamingEnhancer(cfg, bundle["params"], bundle["state"], batch_size=batch,
                                 chunk_frames=chunk_frames, device=dev)
    state = enhancer.init_state()
    chunk = torch.zeros(batch, chunk_frames * cfg.hop_length, dtype=torch.float32, device=dev)
    with torch.no_grad():
        exported = torch.export.export(_Step(enhancer), (state, chunk))
    return exported, enhancer, state, chunk


def roundtrip_check(path, args, reference_out, atol=0.0):
    """Load and run the artifact at ``path``; hold every output leaf against
    the live graph's within ``atol`` (0: equal). Returns the loaded program."""
    restored = torch.export.load(str(path))
    with torch.no_grad():
        got = restored.module()(*args)
    ref_flat, got_flat = state_leaves(reference_out), state_leaves(got)
    assert len(ref_flat) == len(got_flat)
    for r, g in zip(ref_flat, got_flat):
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=atol, rtol=0)
    return restored


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-O", "--output_dir", required=True)
    p.add_argument("--npz", default=None, help="framework .npz weights (convert_checkpoint)")
    p.add_argument("--what", nargs="+", default=["offline", "streaming"],
                   choices=["offline", "streaming"])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--chunk_frames", type=int, default=1)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--sr", type=int, default=16000)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--scan_mode", default="fused",
                   help="execution strategy baked into the offline artifact (fused: the "
                        "layered formulation on kernel F on the card; auto: kernel C)")
    p.add_argument("--check", action="store_true", help="load + verify against the live graph")
    args = p.parse_args(argv)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    bundle = build_bundle(args.npz, device=args.device, scan_mode=args.scan_mode,
                          collect_layer_outputs=False)
    cfg = bundle["config"]
    device = torch.device(args.device)
    manifest = {
        "sample_rate": args.sr,
        "hop_length": cfg.hop_length,
        "n_fft": cfg.n_fft,
        "platforms": [device.type],
        "torch_version": torch.__version__,
        "requires": REQUIRES,
        "weights": args.npz or "fresh-init",
        "artifacts": {},
    }

    if "offline" in args.what:
        exported, example = export_offline(bundle, args.batch, args.seconds, args.sr)
        name = f"enhance_b{args.batch}_t{example.shape[1]}.pt2"
        torch.export.save(exported, str(out_dir / name))
        manifest["artifacts"]["offline"] = {
            "file": name,
            "scan_mode": args.scan_mode,
            "input": {"shape": list(example.shape), "dtype": "float32"},
            "output": "enhanced [batch, samples] float32",
            "bytes": (out_dir / name).stat().st_size,
        }
        if args.check:
            with torch.no_grad():
                ref = _Enhance(bundle)(example)
            roundtrip_check(out_dir / name, (example,), ref)
            print(f"offline: roundtrip check OK ({name})")

    if "streaming" in args.what:
        exported, enhancer, state, chunk = export_streaming(bundle, args.batch,
                                                            args.chunk_frames)
        name = f"streaming_step_b{args.batch}_cf{args.chunk_frames}.pt2"
        torch.export.save(exported, str(out_dir / name))
        # the initial state: a serving process has no model code, so ship the
        # zero state as an .npz of leaves by path (runtime/convert.load_npz
        # nests it back; the artifact takes it in that nesting)
        paths, leaves = state_paths(state), state_leaves(state)
        state_name = f"streaming_init_state_b{args.batch}.npz"
        np.savez(out_dir / state_name, **{k: v.cpu().numpy() for k, v in zip(paths, leaves)})
        manifest["artifacts"]["streaming"] = {
            "file": name,
            "chunk_samples": int(chunk.shape[1]),
            "latency_budget_ms": args.chunk_frames * cfg.hop_length / args.sr * 1e3,
            "state": "nested dicts and lists of float32 tensors; initial value shipped as "
                     "init_state_file (leaves by /-joined path) - thread the step's returned "
                     "state back in",
            "init_state_file": state_name,
            "init_state_leaves": [{"path": k, "shape": list(v.shape), "dtype": "float32"}
                                  for k, v in zip(paths, leaves)],
            "bytes": (out_dir / name).stat().st_size,
        }
        if args.check:
            with torch.no_grad():
                ref = enhancer.eager_step(state, chunk)
            roundtrip_check(out_dir / name, (state, chunk), ref)
            print(f"streaming: roundtrip check OK ({name})")

    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=2))
    print(f"Wrote {len(manifest['artifacts'])} artifact(s) + manifest.json to {out_dir}")
    return manifest


if __name__ == "__main__":
    main()
