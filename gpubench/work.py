"""The work counts the per-layer metrics divide by, worked out from the
configuration and the cell's shapes alone, never from the program's plans,
packed weights or outputs.

- ``model_flops_per_frame``: a frozen copy of the arithmetic of the
  program's ``runtime/roofline.spiking_fullsubnet_cost`` (matmul FLOPs of
  one STFT frame for one utterance; 1 MAC = 2 FLOPs; the deep filter 4 real
  MACs a tap and bin; the STFT and iSTFT as framed DFT products).
- ``kernel_*``: operations and bytes of one launch of a kernel at a shape.
  Products are counted dense (a spike is a 0/1 operand like any other);
  each input is read once and each output written once. Products are timed
  at the configured precision's peak, the cell arithmetic (gate
  nonlinearity, membrane, batch statistics, threshold) at the float32 peak,
  bytes at the memory bandwidth, and the least time is the largest of the
  three.

``PEAKS``: NVIDIA's data sheet for the H100 SXM at its full 700 W power
limit, dense rates; a card set below 700 W runs slower, so every report
prints the card's power limit beside these.
"""

from __future__ import annotations

from typing import Any, Dict

from .reference import sections

PEAKS = {"bfloat16": 989e12, "float32": 67e12, "hbm_bytes_per_s": 3.35e12, "power_w": 700.0}

# float32 operations of the GSU cell a (row, hidden unit, step): bias adds
# (2), sigmoid (4), membrane f c + (1 - f) g (3), batch statistics (3) and
# the normalisation (4) under BN, threshold (1)
CELL_FWD_OPS = 17
# a complex multiply-add of the deep filter
DF_OPS = 8


def _gsu_stack_macs(input_size: int, hidden: int, num_layers: int, shared: bool,
                    proj: int) -> int:
    rows = hidden if shared else 2 * hidden
    macs, fin = 0, input_size
    for _ in range(num_layers):
        macs += fin * rows + hidden * rows
        fin = hidden
    return macs + hidden * proj


def model_flops_per_frame(g: Dict[str, Any]) -> float:
    """Matmul FLOPs of one STFT frame for one utterance."""
    macs = _gsu_stack_macs(g["fb_in"], g["fb_H"], g["fb_L"], g["shared"], g["fb_P"])
    for s in sections(g):
        macs += s["units"] * _gsu_stack_macs(s["in"], g["sb_H"], g["sb_L"], g["shared"],
                                             s["proj"])
        macs += 4 * s["df"] * (s["hi"] - s["lo"])
    macs += 2 * g["win"] * (g["n_fft"] + 2)
    return 2.0 * macs


def model_flops_per_audio_second(g: Dict[str, Any], sample_rate: int) -> float:
    return model_flops_per_frame(g) * sample_rate / g["hop"]


def frames(g: Dict[str, Any], n_samples: int) -> int:
    """STFT frames of an utterance (centred)."""
    return 1 + n_samples // g["hop"]


def least_time(w: Dict[str, float], precision: str) -> float:
    """Seconds the card needs at least for work ``w`` (products, cell, bytes)."""
    return max(w["products"] / PEAKS[precision], w["cell"] / PEAKS["float32"],
               w["bytes"] / PEAKS["hbm_bytes_per_s"])


def _units(g: Dict[str, Any]) -> int:
    return sum(s["units"] for s in sections(g))


def kernel_c(g: Dict[str, Any], batch: int, n_samples: int, io_bytes: int) -> Dict[str, float]:
    """Kernel C: the whole serving model, one launch a forward. Its products
    are the model's; its cell arithmetic every GSU cell and the deep
    filter; its bytes the audio in (stream type) and out (float32) and every
    weight once."""
    T = frames(g, n_samples)
    G = 1 if g["shared"] else 2
    cells = g["fb_L"] * g["fb_H"] + _units(g) * g["sb_L"] * g["sb_H"]
    df = sum(s["df"] * (s["hi"] - s["lo"]) for s in sections(g))
    params = (g["fb_in"] * G * g["fb_H"] + (g["fb_L"] - 1) * G * g["fb_H"] ** 2
              + g["fb_L"] * G * g["fb_H"] ** 2 + g["fb_H"] * g["fb_P"])
    for s in sections(g):
        params += (s["in"] * G * g["sb_H"] + (g["sb_L"] - 1) * G * g["sb_H"] ** 2
                   + g["sb_L"] * G * g["sb_H"] ** 2 + g["sb_H"] * s["proj"])
    return {"products": model_flops_per_frame(g) * T * batch,
            "cell": (CELL_FWD_OPS * cells + DF_OPS * df) * T * batch,
            "bytes": batch * n_samples * (io_bytes + 4) + params * io_bytes}


def kernel_b(g: Dict[str, Any], batch: int, n_samples: int, io_bytes: int) -> Dict[str, float]:
    """Kernel B: every section's units through their GSU stacks, layer 0's
    input products from the magnitude and the fullband output, the
    projection and the deep filter, one launch a forward. Reads the
    magnitude and fullband output (stream type) and the spectrum (float32),
    writes the enhanced spectrum (float32)."""
    T = frames(g, n_samples)
    G = 1 if g["shared"] else 2
    H, L = g["sb_H"], g["sb_L"]
    macs = sum(s["units"] * (s["in"] * G * H + (L - 1) * G * H * H + L * G * H * H + H * s["proj"])
               for s in sections(g))
    df = sum(s["df"] * (s["hi"] - s["lo"]) for s in sections(g))
    nf = g["n_fft"] // 2
    weights = sum(s["in"] * G * H + (L - 1) * G * H * H + L * G * H * H + H * s["proj"]
                  for s in sections(g))
    return {"products": 2.0 * macs * T * batch,
            "cell": (CELL_FWD_OPS * _units(g) * L * H + DF_OPS * df) * T * batch,
            "bytes": T * batch * ((nf + g["fb_P"]) * io_bytes + 2 * (nf + 1) * 4 + 2 * nf * 4)
            + weights * io_bytes}
