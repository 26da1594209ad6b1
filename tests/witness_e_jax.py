"""The JAX package's bf16 train kernel (``gsu_pallas._run_bwd``, kernel E's
reference, in interpret mode on the CPU) on the arguments of a launch of
kernel E that ``train_witness.py`` recorded on the card and saved to
``witness_e.pt``: the frames from a little before the first non-finite one
to the end of the sequence (its first frame is taken as the sequence
start, so every later frame sees the same carried gradients as in the
whole run).

Two time plans: one frame per time block, each block entered from the saved
float32 membranes (so every step recomputes from float32 y, as the port's
kernel does), with y given in float32 and in bfloat16 (the JAX kernel's own
storage of y); and the kernel's own plan (``_make_cfg``), which recomputes
from bf16 y inside a block. Beside them the port's plain version on the
CPU with the same bf16 streams and in float64. Not collected by pytest; run
on the CPU from the repository root:

    JAX_PLATFORMS=cpu python tests/witness_e_jax.py [chiprun_out/witness_e.pt]

Prints one JSON object.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

import jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

from spiking_fullsubnet_tpu.ops import gsu_pallas as gp  # noqa: E402
from spiking_fullsubnet_torch.ops import gsu_kernels as gk  # noqa: E402


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def summary(dxg: np.ndarray, ref: np.ndarray) -> dict:
    bad = ~np.isfinite(dxg).reshape(dxg.shape[0], -1).all(axis=1)
    fin = np.where(np.isfinite(dxg), np.abs(dxg), 0.0)
    both = np.isfinite(dxg) & np.isfinite(ref)
    return {"finite": bool(not bad.any()),
            "last_nonfinite_frame": int(np.nonzero(bad)[0].max()) if bad.any() else None,
            "nonfinite_frames": int(bad.sum()), "max_abs_finite_dxg": float(fin.max()),
            "rel_l2_vs_port_kernel_where_both_finite": float(
                np.linalg.norm((dxg - ref)[both]) / max(np.linalg.norm(ref[both]), 1e-300))}


def jax_bwd(blob: dict, t_blk: int | None, y_bf16: bool) -> np.ndarray:
    xg, y, gout, stats = blob["xg"], blob["y"], blob["gout"], blob["stats"]
    whh, b2, bnp, H, shared = blob["whh"], blob["b2"], blob["bnp"], blob["hidden"], blob["shared"]
    T, R, G = xg.shape
    cfg = gp._make_cfg(T, R, H, shared, bn=True, affine=False, train=True, save_res=True,
                       t_blk=t_blk, io="bfloat16")
    tp = cfg.n_t * cfg.t_blk
    hp, g = cfg.hp, cfg.g

    def lanes(a: np.ndarray, width: int, halves: bool) -> np.ndarray:
        out = np.zeros(a.shape[:-1] + (width,), np.float32)
        if halves:
            out[..., :H], out[..., hp:hp + H] = a[..., :H], a[..., H:]
        else:
            out[..., :a.shape[-1]] = a
        return out

    def pad_t(a: np.ndarray) -> np.ndarray:
        return np.concatenate([a, np.zeros((tp - T,) + a.shape[1:], a.dtype)]) if tp > T else a

    halves = not shared
    xg_p = jnp.asarray(pad_t(lanes(_np(xg), g, halves)), jnp.bfloat16)
    y_np = pad_t(lanes(_np(y), hp, False))
    y_p = jnp.asarray(y_np, jnp.bfloat16 if y_bf16 else jnp.float32)
    gout_p = jnp.asarray(pad_t(lanes(_np(gout), hp, False)), jnp.bfloat16)
    st = np.zeros((tp, 2, hp), np.float32)
    st[:T, :, :H] = _np(stats)
    # block-entry membranes: y of the frame before each block, float32
    bnd = np.zeros((cfg.n_t, R, hp), np.float32)
    for ti in range(1, cfg.n_t):
        bnd[ti] = y_np[ti * cfg.t_blk - 1]
    w = np.zeros((hp, g), np.float32)
    wn = _np(whh)
    if shared:
        w[:H, :H] = wn
    else:
        w[:H, :H], w[:H, hp:hp + H] = wn[:, :H], wn[:, H:]
    b2p = np.zeros((2, hp), np.float32)
    b2p[:, :H] = _np(b2)
    bnpp = np.zeros((2, hp), np.float32)
    bnpp[:, :H] = _np(bnp)
    gp._INTERPRET = True
    dxg, _, _, _ = gp._run_bwd(cfg, xg_p, y_p, gout_p, jnp.asarray(bnd), jnp.asarray(st),
                               jnp.asarray(w), jnp.asarray(b2p), jnp.asarray(bnpp))
    d = np.asarray(dxg.astype(jnp.float32))[:T]
    return np.concatenate([d[..., :H], d[..., hp:hp + H]], -1) if halves else d[..., :H]


def main() -> int:
    path = Path(sys.argv[1] if len(sys.argv) > 1 else "chiprun_out/witness_e.pt")
    blob = torch.load(path)
    ref = _np(blob["kernel_dxg"])
    args = (blob["xg"], blob["y"], blob["gout"], blob["stats"], blob["whh"], blob["b2"],
            blob["bnp"], blob["hidden"], blob["shared"], blob["mode"])
    out = {"frames": int(blob["xg"].shape[0]), "start": int(blob["start"]), "T": int(blob["T"]),
           "port kernel (card)": summary(ref, ref)}
    plain = gk.layer_train_bwd_plain(*args)[0]
    out["port plain, bf16 streams"] = summary(_np(plain), ref)
    f64 = [a.double() if torch.is_tensor(a) else a for a in args]
    out["port plain, float64"] = summary(gk.layer_train_bwd_plain(*f64)[0].numpy(), ref)
    for label, t_blk, y_bf16 in (("JAX, one frame a block, y float32", 1, False),
                                 ("JAX, one frame a block, y bf16", 1, True),
                                 ("JAX, its own time blocks, y bf16", None, True)):
        out[label] = summary(jax_bwd(blob, t_blk, y_bf16), ref)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
