"""Analytic roofline and MFU accounting for Spiking-FullSubNet (counterpart
of ``spiking_fullsubnet_tpu/runtime/roofline.py``).

The model's matmul FLOPs and least activation bytes per STFT frame come
from its configuration, as in the JAX module: 1 MAC = 2 FLOPs; only matmul
work counts toward MFU; activations cross device memory once per stack
boundary. A measured throughput (audio-seconds per second) then gives the
fraction of the card's peak and of its roofline that it reaches.

``CHIP_SPECS`` holds the H100 only: NVIDIA's data sheet for the SXM part at
its full 700 W power limit, dense rates (the constants of ``chip_smoke.py``'s
bounds): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside
them (TF32 off), 3.35 TB/s of HBM3. A card set below 700 W runs slower; state
its power limit beside a report.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

# the key "hbm_gbps" holds bytes per second, as in the JAX module's table
CHIP_SPECS: Dict[str, Dict[str, float]] = {
    "h100_sxm": {"bf16": 989e12, "f32": 67e12, "hbm_gbps": 3.35e12},
}


@dataclass(frozen=True)
class ModelCost:
    flops_per_frame_per_item: float  # matmul FLOPs, one STFT frame, batch 1
    bytes_per_frame_per_item: float  # least activation traffic
    frames_per_audio_second: float

    def flops_per_audio_second(self) -> float:
        return self.flops_per_frame_per_item * self.frames_per_audio_second

    def bytes_per_audio_second(self) -> float:
        return self.bytes_per_frame_per_item * self.frames_per_audio_second


def _gsu_stack_macs(input_size: int, hidden: int, num_layers: int,
                    shared: bool, proj: int) -> int:
    """MACs of one GSU stack and its projection for one row and time step."""
    rows = hidden if shared else 2 * hidden
    macs = 0
    fin = input_size
    for _ in range(num_layers):
        macs += fin * rows  # input projection
        macs += hidden * rows  # recurrent projection
        fin = hidden
    macs += hidden * proj
    return macs


def spiking_fullsubnet_cost(cfg, sample_rate: int = 16000,
                            dtype_bytes: int = 4) -> ModelCost:
    """Cost of a ``SpikingFullSubNetConfig`` per STFT frame, batch 1."""
    frames_per_second = sample_rate / cfg.hop_length

    fbc = cfg.fb_config()
    macs = _gsu_stack_macs(fbc.input_size, fbc.hidden_size, fbc.num_layers,
                           fbc.shared_weights, fbc.proj_size)
    act_elems = fbc.input_size + fbc.proj_size  # the fullband's input and output

    for i in range(cfg.num_sections):
        sbc = cfg.sb_config(i)
        ctr = cfg.center_freq_sizes[i]
        width = cfg.freq_cutoffs[i + 1] - cfg.freq_cutoffs[i]
        n_units = width // ctr  # sub-band rows per batch item
        macs += n_units * _gsu_stack_macs(
            sbc.input_size, sbc.hidden_size, sbc.num_layers,
            sbc.shared_weights, sbc.proj_size)
        act_elems += n_units * (sbc.input_size + sbc.proj_size)
        # deep filter: one complex MAC (4 real) per (tap, bin)
        macs += 4 * cfg.df_orders[i] * width

    # the STFT and iSTFT as framed DFT matmuls, [win] x [win, n_fft + 2] each way
    macs += 2 * cfg.win_length * (cfg.n_fft + 2)
    act_elems += 2 * (cfg.n_fft + 2)

    return ModelCost(
        flops_per_frame_per_item=2.0 * macs,
        bytes_per_frame_per_item=float(dtype_bytes * act_elems),
        frames_per_audio_second=frames_per_second,
    )


def roofline_report(cfg, audio_seconds_per_second: float,
                    chip: str = "h100_sxm", matmul_dtype: str = "bf16",
                    sample_rate: int = 16000) -> Dict[str, float]:
    """MFU and roofline fraction of a measured enhance throughput."""
    spec = CHIP_SPECS[chip]
    cost = spiking_fullsubnet_cost(
        cfg, sample_rate, dtype_bytes=2 if matmul_dtype == "bf16" else 4)
    achieved_flops = cost.flops_per_audio_second() * audio_seconds_per_second
    achieved_bytes = cost.bytes_per_audio_second() * audio_seconds_per_second
    peak_flops = spec[matmul_dtype if matmul_dtype in spec else "bf16"]
    # least time per audio-second: compute and memory overlap
    t_flops = cost.flops_per_audio_second() / peak_flops
    t_bytes = cost.bytes_per_audio_second() / spec["hbm_gbps"]
    t_min = max(t_flops, t_bytes)
    return {
        "mfu": achieved_flops / peak_flops,
        "memory_bw_util": achieved_bytes / spec["hbm_gbps"],
        "fraction_of_roofline": t_min * audio_seconds_per_second,
        "bound": "compute" if t_flops >= t_bytes else "memory",
        "model_gflops_per_audio_second": cost.flops_per_audio_second() / 1e9,
        "roofline_audio_s_per_s": 1.0 / t_min,
        "chip": chip,
    }
