"""Hopper kernels of the GSU recurrence, their plain PyTorch versions and
their loader (counterpart of ``spiking_fullsubnet_tpu/ops/gsu_pallas.py``).

Six kernels, each a hand-written CUDA C++ source under ``../csrc``:

- ``gsu_stack_eval`` (kernel A, ``csrc/gsu_stack_eval.cu``) replaces
  ``_stack_eval_xg_kernel`` / ``gsu_stack_eval_pallas_xg``: an L-layer GSU
  stack in eval mode with the layer-0 gates given.
- ``gsu_sections_eval`` (kernel B, ``csrc/gsu_sections_eval.cu``) replaces
  ``_sections_kernel`` / ``gsu_sections_eval_pallas`` in each of its modes:
  all sub-band sections with their layer-0 gates scaled per utterance, per
  frame (with the pre-LN terms or without) or not at all, their projection
  and the deep filter, or the projection itself.
- ``sfsb_monolith_serve`` (kernel C, ``csrc/sfsb_monolith_serve.cu``)
  replaces ``_monolith_kernel`` / ``sfsb_monolith_serve_pallas``: the whole
  serving model per step, audio hop chunks in, enhanced hop chunks out.
- ``gsu_stack_eval_x`` (kernel F, ``csrc/gsu_stack_eval_x.cu``) replaces
  ``_stack_eval_kernel`` / ``gsu_stack_eval_pallas``: an L-layer GSU stack
  in eval mode from the raw features (layer 0's input projection inside the
  kernel), every layer's spikes out; the layered forward's stacks.
- ``gsu_layer_train_fwd`` (kernel D, ``csrc/gsu_train_fwd.cu``) replaces
  ``_fwd_kernel`` / ``_run_fwd``: one GSU layer over the sequence with
  batch-statistics BatchNorm (training), a folded affine (eval) or none,
  saving the membranes and the per-step statistics for the backward.
- ``gsu_layer_train_bwd`` (kernel E, ``csrc/gsu_train_bwd.cu``) replaces
  ``_bwd_kernel`` / ``_run_bwd``: D's reverse-time backward; its weight
  gradient is a second kernel of the same source, ``gsu_train_dw``.
  D and E take float32 streams (the layered path) or bfloat16 streams (the
  stream-train path, ``_KCfg.io``); membranes and statistics are float32.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; a CUDA tensor never takes the plain path. Each wrapper
counts its launches in ``<wrapper>.launches``. The plain versions are
public (``stack_eval_plain``, ``sections_eval_plain``,
``monolith_serve_plain``, ``stack_eval_x_plain``, ``layer_train_fwd_plain``,
``layer_train_bwd_plain``, ``train_dw_plain``), accept float64 and are the
kernels' oracles.

The kernels are compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared`` (one nvcc per library, all
started together; kernel C is two libraries, one per stream type) into
``spiking_fullsubnet_torch/_build/`` and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .gsu import BN_EPS, acc_dtype_for, bn_eval_affine

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# library name -> (source, defines). Kernel C builds one library per stream
# type, so that its two instances compile in parallel.
SOURCES = {"stack": ("gsu_stack_eval.cu", ()), "sections": ("gsu_sections_eval.cu", ()),
           "stack_x": ("gsu_stack_eval_x.cu", ()), "train_fwd": ("gsu_train_fwd.cu", ()),
           "train_bwd": ("gsu_train_bwd.cu", ())}
SOURCES.update({f"monolith_{io}": ("sfsb_monolith_serve.cu", (f"-DMONO_BF16={int(io == 'bf16')}",))
                for io in ("f32", "bf16")})
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_LAYERS = 4

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # nvcc/ptxas output per source, for the record

# ------------------------------------------------------------------ build/load


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode() + f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + list(SOURCES[name][1])).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_kernels() -> float:
    """Compile every kernel source not built yet, all nvcc processes at once,
    and load the libraries. Returns the seconds spent. Raises on failure."""
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if n not in _LIBS]
    procs = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in todo:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src, defines = SOURCES[name]
        cmd = [_nvcc(), *NVCC_FLAGS, *defines, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    for name in todo:
        _LIBS[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
    return time.perf_counter() - t0


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    if name == "stack":
        lib.gsu_stack_eval_launch.argtypes = [I, P, P, P, P, P, I, I, I, I, I, I, I, P]
        lib.gsu_stack_eval_launch.restype = I
    elif name == "stack_x":
        lib.gsu_stack_eval_x_launch.argtypes = [I, P, P, P, P, P, P, I, I, I, I, I, I, P]
        lib.gsu_stack_eval_x_launch.restype = I
    elif name == "sections":
        lib.gsu_sections_eval_launch.argtypes = (
            [I, I, P, I, I] + [P] * 17 + [I] * 10 + [P])
        lib.gsu_sections_eval_launch.restype = I
    elif name == "train_fwd":
        lib.gsu_train_fwd_launch.argtypes = [I] + [P] * 7 + [I] * 5 + [P]
        lib.gsu_train_fwd_launch.restype = I
    elif name == "train_bwd":
        lib.gsu_train_bwd_launch.argtypes = [I] + [P] * 12 + [I] * 5 + [P]
        lib.gsu_train_bwd_launch.restype = I
        lib.gsu_train_dw_launch.argtypes = [I] + [P] * 4 + [I] * 5 + [ctypes.c_longlong, P]
        lib.gsu_train_dw_launch.restype = I
    else:
        lib.sfsb_monolith_launch.argtypes = [I, ctypes.POINTER(_MonoArgs), P]
        lib.sfsb_monolith_launch.restype = I
        lib.sfsb_monolith_max_clusters.argtypes = [I, ctypes.POINTER(_MonoArgs),
                                                   ctypes.POINTER(I)]
        lib.sfsb_monolith_max_clusters.restype = I
    lib.gsu_error_string.argtypes = [I]
    lib.gsu_error_string.restype = ctypes.c_char_p
    return lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build_kernels()
    return _LIBS[name]


CUDA_ERROR_INVALID_VALUE = 1


def _check_rc(lib: ctypes.CDLL, rc: int, what: str, limits: str = "") -> None:
    """Raises on a launcher's error code. A launcher that checks its sizes
    itself returns cudaErrorInvalidValue beyond them: ``limits`` says what
    they are."""
    if rc == CUDA_ERROR_INVALID_VALUE and limits:
        raise ValueError(f"{what}: {limits}")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {lib.gsu_error_string(rc).decode()} ({rc})")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, device: torch.device,
                shape: Optional[Sequence[int]] = None) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


# ------------------------------------------------------------------ packing


def pack_stack(layers: List[Dict[str, Any]], layer_states: List[Dict[str, Any]],
               hidden: int, io_dtype: torch.dtype):
    """Torch-layout stack params -> kernel layout.

    Returns (wihr [max(L-1,1), H, G], whh [L, H, G]) in ``io_dtype`` (G = H
    shared, else 2H with the f half first) and coef [L, 4, H] = (b_f, b_c,
    BN scale, BN shift) in the accumulation type. The weights are taken as
    given (already cast by the caller's precision policy)."""
    acc = acc_dtype_for(io_dtype)
    H = hidden
    dev = layers[0]["weight_hh"].device
    whh = torch.stack([lp["weight_hh"].T for lp in layers]).to(io_dtype).contiguous()
    if len(layers) > 1:
        wihr = torch.stack([lp["weight_ih"].T for lp in layers[1:]]).to(io_dtype).contiguous()
    else:
        wihr = torch.zeros((1,) + whh.shape[1:], dtype=io_dtype, device=dev)
    coef = []
    for lp, ls in zip(layers, layer_states):
        b = lp["bias_ih"].to(acc)
        if "bn" in lp:
            scale, shift = bn_eval_affine(lp, ls, acc)
        else:
            scale = torch.ones(H, dtype=acc, device=dev)
            shift = torch.zeros(H, dtype=acc, device=dev)
        coef.append(torch.stack([b[:H], b[H:], scale, shift]))
    return wihr, whh, torch.stack(coef).contiguous()


# ------------------------------------------------------------------ kernel A


def _stack_layers_step(x0, h, c, wihr, whh, coef, H: int, shared: bool):
    """One timestep of the stack on rows [R, *]: updates h, c lists in place."""
    inp = x0
    for k in range(len(h)):
        xg = inp if k == 0 else h[k - 1] @ wihr[k - 1]
        pre = xg + h[k] @ whh[k]
        b_f, b_c, scale, shift = coef[k]
        if shared:
            f = torch.sigmoid(pre + b_f)
            g = pre + b_c
        else:
            f = torch.sigmoid(pre[:, :H] + b_f)
            g = pre[:, H:] + b_c
        c[k] = (f * c[k] + (1.0 - f) * g) * scale + shift
        h[k] = (c[k] >= 0.0).to(c[k].dtype)


def _stack_plain(gates0, T: int, R: int, io: torch.dtype, wihr: torch.Tensor,
                 whh: torch.Tensor, coef: torch.Tensor, hidden: int, shared: bool,
                 collect_all: bool, spike_counts: Optional[List[float]]) -> torch.Tensor:
    """The time loop of the plain versions of kernels A and F: ``gates0(t)``
    gives layer 0's input gates ``[R, G]`` of step t in the accumulation
    type. Returns every layer's spikes ``[L, T, R, H]`` (``collect_all``) or
    the last one's ``[1, T, R, H]``, in ``io``.

    ``spike_counts``, when a list, receives each layer's number of spikes
    over the whole run: the nonzero inputs of the spike products, from
    which a caller counts the operations the data needs."""
    acc = acc_dtype_for(io)
    dev = whh.device
    L = whh.shape[0]
    wihr_a, whh_a, coef_a = wihr.to(acc), whh.to(acc), coef.to(acc)
    h = [torch.zeros(R, hidden, dtype=acc, device=dev) for _ in range(L)]
    c = [torch.zeros(R, hidden, dtype=acc, device=dev) for _ in range(L)]
    out = torch.empty((L if collect_all else 1, T, R, hidden), dtype=io, device=dev)
    tot = torch.zeros(L, dtype=torch.float64, device=dev)
    for t in range(T):
        _stack_layers_step(gates0(t), h, c, wihr_a, whh_a, coef_a, hidden, shared)
        if spike_counts is not None:
            tot += torch.stack([hk.sum(dtype=torch.float64) for hk in h])
        if collect_all:
            for k in range(L):
                out[k, t] = h[k].to(io)
        else:
            out[0, t] = h[-1].to(io)
    if spike_counts is not None:
        spike_counts.extend(tot.tolist())
    return out


def stack_eval_plain(xg0: torch.Tensor, wihr: torch.Tensor, whh: torch.Tensor,
                     coef: torch.Tensor, hidden: int, shared: bool,
                     collect_all: bool = False,
                     spike_counts: Optional[List[float]] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel A (same arguments and result);
    ``spike_counts`` as in ``_stack_plain``."""
    units = xg0.ndim == 4
    io = xg0.dtype
    acc = acc_dtype_for(io)
    x = xg0.transpose(0, 1) if units else xg0  # [T, (U,) R, G]
    T, G = x.shape[0], x.shape[-1]
    lead = x.shape[1:-1]
    x = x.reshape(T, -1, G)
    out = _stack_plain(lambda t: x[t].to(acc), T, x.shape[1], io, wihr, whh, coef, hidden,
                       shared, collect_all, spike_counts)
    out = out.reshape((out.shape[0], T) + tuple(lead) + (hidden,))
    if units:
        out = out.transpose(1, 2)
    return out.contiguous() if collect_all else out[0].contiguous()


def gsu_stack_eval(xg0: torch.Tensor, wihr: torch.Tensor, whh: torch.Tensor,
                   coef: torch.Tensor, hidden: int, shared: bool,
                   collect_all: bool = False) -> torch.Tensor:
    """Eval forward of an L-layer GSU stack with layer 0's gates given.

    xg0 ``[T, R, G]`` or ``[U, T, R, G]`` (f32/bf16 on the card; also f64 on
    the CPU), G = H (shared) or 2H (f half first); weights from
    ``pack_stack``. Returns the last layer's spikes ``[..., H]`` in xg0's
    type, or every layer's stacked on a leading axis with ``collect_all``."""
    if not xg0.is_cuda:
        return stack_eval_plain(xg0, wihr, whh, coef, hidden, shared, collect_all)
    H, L = hidden, whh.shape[0]
    G = H if shared else 2 * H
    if xg0.ndim not in (3, 4) or xg0.shape[-1] != G:
        raise ValueError(f"xg0 shape {tuple(xg0.shape)}: expected [(U,) T, R, {G}]")
    if xg0.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xg0 dtype {xg0.dtype}: the kernel takes float32 or bfloat16")
    if not 1 <= L <= MAX_LAYERS or not 1 <= H <= 512:
        raise ValueError(f"L={L}, H={H}: the kernel takes 1..{MAX_LAYERS} layers, H <= 512")
    dev, io = xg0.device, xg0.dtype
    _check_cuda("xg0", xg0, io, dev)
    _check_cuda("wihr", wihr, io, dev, (max(L - 1, 1), H, G))
    _check_cuda("whh", whh, io, dev, (L, H, G))
    _check_cuda("coef", coef, torch.float32, dev, (L, 4, H))
    U, T, R = (xg0.shape[:3] if xg0.ndim == 4 else (1,) + tuple(xg0.shape[:2]))
    out_shape = ((L,) if collect_all else ()) + tuple(xg0.shape[:-1]) + (H,)
    out = torch.empty(out_shape, dtype=io, device=dev)
    lib = _lib("stack")
    with torch.cuda.device(dev):
        rc = lib.gsu_stack_eval_launch(
            int(io == torch.bfloat16), _ptr(xg0), _ptr(wihr), _ptr(whh), _ptr(coef), _ptr(out),
            U, T, R, H, L, int(shared), int(collect_all), _stream())
    _check_rc(lib, rc, "gsu_stack_eval")
    gsu_stack_eval.launches += 1
    return out


gsu_stack_eval.launches = 0


# ------------------------------------------------------------------ kernel F


def pack_stack_x(layers: List[Dict[str, Any]], layer_states: List[Dict[str, Any]],
                 hidden: int, io_dtype: torch.dtype):
    """``pack_stack`` plus layer 0's input weights: (wih0 [F, G], wihr, whh,
    coef), the weights in ``io_dtype``, coef in the accumulation type."""
    wih0 = layers[0]["weight_ih"].T.to(io_dtype).contiguous()
    return (wih0,) + pack_stack(layers, layer_states, hidden, io_dtype)


def stack_eval_x_plain(x: torch.Tensor, wih0: torch.Tensor, wihr: torch.Tensor,
                       whh: torch.Tensor, coef: torch.Tensor, hidden: int, shared: bool,
                       spike_counts: Optional[List[float]] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel F (same arguments and result): layer
    0's gates ``x[t] @ wih0`` step by step in the accumulation type.
    ``spike_counts`` as in ``_stack_plain``."""
    acc = acc_dtype_for(x.dtype)
    T, R, _ = x.shape
    wih0_a = wih0.to(acc)
    return _stack_plain(lambda t: x[t].to(acc) @ wih0_a, T, R, x.dtype, wihr, whh, coef, hidden,
                        shared, True, spike_counts)


def gsu_stack_eval_x(x: torch.Tensor, wih0: torch.Tensor, wihr: torch.Tensor,
                     whh: torch.Tensor, coef: torch.Tensor, hidden: int,
                     shared: bool) -> torch.Tensor:
    """Eval forward of an L-layer GSU stack from the raw features.

    x ``[T, R, F]`` (f32/bf16 on the card; also f64 on the CPU); weights from
    ``pack_stack_x``. Returns every layer's spikes ``[L, T, R, H]`` in x's
    type."""
    if not x.is_cuda:
        return stack_eval_x_plain(x, wih0, wihr, whh, coef, hidden, shared)
    H, L = hidden, whh.shape[0]
    G = H if shared else 2 * H
    if x.ndim != 3:
        raise ValueError(f"x shape {tuple(x.shape)}: expected [T, R, F]")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x dtype {x.dtype}: the kernel takes float32 or bfloat16")
    if not 1 <= L <= MAX_LAYERS or not 1 <= H <= 512:
        raise ValueError(f"L={L}, H={H}: the kernel takes 1..{MAX_LAYERS} layers, H <= 512")
    T, R, Fin = x.shape
    if R < 1 or Fin < 1 or (L * H + Fin) * 8 * 4 > 232448:
        raise ValueError(f"R={R}, F={Fin}: the kernel takes R, F >= 1 and (L H + F) 32 bytes "
                         "of shared memory within 227 KB")
    dev, io = x.device, x.dtype
    _check_cuda("x", x, io, dev)
    _check_cuda("wih0", wih0, io, dev, (Fin, G))
    _check_cuda("wihr", wihr, io, dev, (max(L - 1, 1), H, G))
    _check_cuda("whh", whh, io, dev, (L, H, G))
    _check_cuda("coef", coef, torch.float32, dev, (L, 4, H))
    out = torch.empty((L, T, R, H), dtype=io, device=dev)
    lib = _lib("stack_x")
    with torch.cuda.device(dev):
        rc = lib.gsu_stack_eval_x_launch(
            int(io == torch.bfloat16), _ptr(x), _ptr(wih0), _ptr(wihr), _ptr(whh), _ptr(coef),
            _ptr(out), T, R, Fin, H, L, int(shared), _stream())
    _check_rc(lib, rc, "gsu_stack_eval_x")
    gsu_stack_eval_x.launches += 1
    return out


gsu_stack_eval_x.launches = 0


# ------------------------------------------------------------------ kernels D and E
#
# One GSU layer in the kernel layout: xg [T, R, G] input gates without bias
# (G = H shared, else 2H with the f half first), whh [H, G] (``h @ whh``),
# b2 [2, H] = (b_f, b_c), bnp [2, H] = (BN weight, bias) in mode "bn" or
# (scale, shift) in mode "affine", unused in mode "none". The streams (xg,
# whh, the spikes, the spikes' gradient and dxg) are float32 or bfloat16
# (``_KCfg.io``, ``gsu_pallas.py:129-133``); the membranes y, the statistics,
# b2, bnp and the weight gradients are float32 (float64 beside float64
# streams in the plain versions). Both kernels run the stack's rows as one
# thread-block cluster (BN statistics cross every row at every step); their
# launchers size it and refuse what does not fit.

TRAIN_MODES = {"none": 0, "bn": 1, "affine": 2}
TRAIN_IO = {torch.float32: 0, torch.bfloat16: 1}
TRAIN_LIMITS = ("it takes H <= 512 and R >= 1 rows split over one cluster of at most 8 "
                "blocks, each block's rows within 227 KB of shared memory")


def _gates(xg_t, h, w, b_f, b_c, H: int, shared: bool):
    """(f, g) of one step: ``pre = xg_t + h @ w``, f = sigmoid(pre_f + b_f),
    g = pre_c + b_c (``_fwd_kernel``'s order of sums)."""
    pre = xg_t + h @ w
    if shared:
        return torch.sigmoid(pre + b_f), pre + b_c
    return torch.sigmoid(pre[:, :H] + b_f), pre[:, H:] + b_c


def layer_train_fwd_plain(xg: torch.Tensor, whh: torch.Tensor, b2: torch.Tensor,
                          bnp: torch.Tensor, hidden: int, shared: bool, mode: str
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel D (same arguments and result), step
    by step as ``_fwd_kernel`` (``gsu_pallas.py:226-287``): mode "bn"
    normalises each step's membranes by their mean and biased variance over
    the R rows (two passes, sums times 1/R), "affine" applies ``c' bnp[0] +
    bnp[1]``. The stream type is xg's (float32, bfloat16 or float64): W_hh
    is rounded to it, the arithmetic runs in ``acc_dtype_for`` of it, and
    the spikes return in it; y and the statistics in the accumulation
    type."""
    T, R, _ = xg.shape
    H, io, dev = hidden, xg.dtype, xg.device
    acc = acc_dtype_for(io)
    w, b2, bnp = whh.to(io).to(acc), b2.to(acc), bnp.to(acc)
    h = torch.zeros(R, H, dtype=acc, device=dev)
    c = torch.zeros(R, H, dtype=acc, device=dev)
    spikes = torch.empty(T, R, H, dtype=io, device=dev)
    y = torch.empty(T, R, H, dtype=acc, device=dev)
    stats = torch.zeros(T, 2, H, dtype=acc, device=dev)
    inv_n = 1.0 / R
    for t in range(T):
        f, g = _gates(xg[t].to(acc), h, w, b2[0], b2[1], H, shared)
        cy = f * c + (1.0 - f) * g
        if mode == "bn":
            mean = cy.sum(0) * inv_n
            var = (cy - mean).square().sum(0) * inv_n
            c = (cy - mean) * torch.rsqrt(var + BN_EPS) * bnp[0] + bnp[1]
            stats[t, 0], stats[t, 1] = mean, var
        elif mode == "affine":
            c = cy * bnp[0] + bnp[1]
        else:
            c = cy
        h = (c >= 0.0).to(acc)
        spikes[t], y[t] = h, c
    return spikes, y, stats


def _check_train_layer(xg: torch.Tensor, whh: torch.Tensor, b2: torch.Tensor,
                       bnp: torch.Tensor, hidden: int, shared: bool, mode: str
                       ) -> Tuple[int, int, int]:
    """Checks common to kernels D and E; returns (T, R, G)."""
    H = hidden
    G = H if shared else 2 * H
    if mode not in TRAIN_MODES:
        raise ValueError(f"mode {mode!r}: expected one of {sorted(TRAIN_MODES)}")
    if xg.ndim != 3 or xg.shape[-1] != G:
        raise ValueError(f"xg shape {tuple(xg.shape)}: expected [T, R, {G}]")
    if xg.dtype not in TRAIN_IO:
        raise ValueError(f"xg dtype {xg.dtype}: the kernel takes float32 or bfloat16 streams")
    T, R, _ = xg.shape
    dev = xg.device
    _check_cuda("xg", xg, xg.dtype, dev)
    _check_cuda("whh", whh, xg.dtype, dev, (H, G))
    _check_cuda("b2", b2, torch.float32, dev, (2, H))
    _check_cuda("bnp", bnp, torch.float32, dev, (2, H))
    return T, R, G


def gsu_layer_train_fwd(xg: torch.Tensor, whh: torch.Tensor, b2: torch.Tensor,
                        bnp: torch.Tensor, hidden: int, shared: bool, mode: str
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One GSU layer forward (kernel D): xg and whh in the stream type
    (float32 or bfloat16 on the card; also float64 on the CPU), b2 and bnp
    in the accumulation type -> (spikes ``[T, R, H]`` in the stream type,
    the membranes y after BN ``[T, R, H]`` and the per-step (mean, biased
    var) ``[T, 2, H]`` in the accumulation type, zero outside mode "bn")."""
    if not xg.is_cuda:
        return layer_train_fwd_plain(xg, whh, b2, bnp, hidden, shared, mode)
    H = hidden
    T, R, _ = _check_train_layer(xg, whh, b2, bnp, H, shared, mode)
    dev = xg.device
    spikes = torch.empty(T, R, H, dtype=xg.dtype, device=dev)
    y = torch.empty(T, R, H, dtype=torch.float32, device=dev)
    stats = torch.zeros(T, 2, H, dtype=torch.float32, device=dev)
    lib = _lib("train_fwd")
    with torch.cuda.device(dev):
        rc = lib.gsu_train_fwd_launch(TRAIN_IO[xg.dtype], _ptr(xg), _ptr(whh), _ptr(b2),
                                      _ptr(bnp), _ptr(spikes), _ptr(y), _ptr(stats), T, R, H,
                                      int(shared), TRAIN_MODES[mode], _stream())
    _check_rc(lib, rc, f"gsu_layer_train_fwd (H={H}, R={R})", TRAIN_LIMITS)
    gsu_layer_train_fwd.launches += 1
    return spikes, y, stats


gsu_layer_train_fwd.launches = 0


def layer_train_bwd_plain(xg: torch.Tensor, y: torch.Tensor, gout: torch.Tensor,
                          stats: torch.Tensor, whh: torch.Tensor, b2: torch.Tensor,
                          bnp: torch.Tensor, hidden: int, shared: bool, mode: str,
                          operands: Optional[torch.dtype] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel E (and of ``gsu_train_dw``): the
    reverse-time loop of ``_bwd_kernel`` (``gsu_pallas.py:358-466``) line by
    line. Each step recomputes the gates from y[t-1] (h = 0 and c = 0 before
    the first step), passes the spike gradient through the triangle
    surrogate max(1 - |y|, 0), applies the exact batch-statistics BN
    backward (mode "bn") and accumulates the weight, bias and BN gradients.
    Types as ``layer_train_fwd_plain``: with bfloat16 streams drg is
    rounded to bfloat16 before dW and dh = drg W_hh^T (``:449-460``), and
    everything else is float32. ``operands`` names another type for that
    rounding (float64 streams with ``operands=torch.bfloat16`` give the
    bf16-stream semantics with every other sum exact). Returns (dxg ``[T,
    R, G]`` in the stream type, dW ``[H, G]``, db ``[2, H]``, dbn ``[2, H]``
    in the accumulation type)."""
    if mode == "affine":
        raise ValueError("kernel E takes mode 'bn' or 'none' (the affine mode is eval only)")
    T, R, G = xg.shape
    H, io, dev = hidden, xg.dtype, xg.device
    acc = acc_dtype_for(io)
    w, b2, gamma = whh.to(io).to(acc), b2.to(acc), bnp[0].to(acc)
    zeros = torch.zeros(R, H, dtype=acc, device=dev)
    dh, dc = zeros, zeros
    dxg = torch.empty(T, R, G, dtype=io, device=dev)
    dw = torch.zeros(H, G, dtype=acc, device=dev)
    db = torch.zeros(2, H, dtype=acc, device=dev)
    dbn = torch.zeros(2, H, dtype=acc, device=dev)
    inv_n = 1.0 / R
    for t in range(T - 1, -1, -1):
        c_prev = y[t - 1].to(acc) if t > 0 else zeros
        h_prev = (c_prev >= 0.0).to(acc) if t > 0 else zeros
        f, g = _gates(xg[t].to(acc), h_prev, w, b2[0], b2[1], H, shared)
        surr = torch.clamp(1.0 - y[t].to(acc).abs(), min=0.0)
        dy = (gout[t].to(acc) + dh) * surr + dc
        if mode == "bn":
            rstd = torch.rsqrt(stats[t, 1].to(acc) + BN_EPS)
            xhat = (f * c_prev + (1.0 - f) * g - stats[t, 0].to(acc)) * rstd
            sum_dy, sum_dyx = dy.sum(0), (dy * xhat).sum(0)
            dbn[0] += sum_dyx
            dbn[1] += sum_dy
            dcr = gamma * rstd * (dy - inv_n * sum_dy - xhat * (inv_n * sum_dyx))
        else:
            dcr = dy
        dpre_f = dcr * (c_prev - g) * f * (1.0 - f)
        dpre_c = dcr * (1.0 - f)
        dc = dcr * f
        db[0] += dpre_f.sum(0)
        db[1] += dpre_c.sum(0)
        drg = dpre_f + dpre_c if shared else torch.cat([dpre_f, dpre_c], dim=1)
        drg = drg.to(operands or io).to(acc)  # the matmul operands in the stream type
        dxg[t] = drg
        dw += h_prev.T @ drg
        dh = drg @ w.T
    return dxg, dw, db, dbn


def train_dw_plain(y: torch.Tensor, dxg: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``gsu_train_dw``: ``dW [H, G] = sum over t
    and rows of h_{t-1}^T dxg_t``, h_{t-1} = (y[t-1] >= 0), zero at t = 0,
    in y's type."""
    H, G = y.shape[-1], dxg.shape[-1]
    h_prev = (y[:-1] >= 0.0).to(y.dtype).reshape(-1, H)
    return h_prev.T @ dxg[1:].reshape(-1, G).to(y.dtype)


H100_SMS = 132
# the dW kernel's output tile (rows and columns) by stream type (DwTile in
# csrc/gsu_train_bwd.cu)
DW_TILE = {torch.bfloat16: 128, torch.float32: 64}
DW_MIN_ROWS = 256  # fewest summed rows worth a split of their own


def dw_split_plan(T: int, R: int, H: int, G: int, io: torch.dtype) -> Tuple[int, int]:
    """The dW kernel's split-K plan for ``io`` streams: ``(splits, chunk)``,
    split s summing the rows ``[s chunk, min(K, (s + 1) chunk))`` of the K =
    (T - 1) R rows of ``h_prev^T dxg`` (a split past K sums nothing and
    writes zeros). The output tiles times the splits are the blocks: the
    splits are the fewest that make them a multiple of the H100's 132 SMs (up to
    two blocks per SM), unless that leaves a split fewer than DW_MIN_ROWS
    rows."""
    K = (T - 1) * R
    tile = DW_TILE[io]
    tiles = -(-H // tile) * -(-G // tile)
    step = H100_SMS // math.gcd(tiles, H100_SMS)
    splits = step * max(1, (2 * H100_SMS) // (tiles * step))
    if K < splits * DW_MIN_ROWS:
        splits = max(1, K // DW_MIN_ROWS)
    return splits, max(1, -(-K // splits))


def gsu_train_dw(y: torch.Tensor, dxg: torch.Tensor) -> torch.Tensor:
    """Kernel E's weight gradient: ``train_dw_plain``'s product summed in
    float32 over every step and row (split over the rows as
    ``dw_split_plan`` says, the partials added in split order); y float32,
    dxg in the stream type."""
    if not y.is_cuda:
        return train_dw_plain(y, dxg)
    T, R, H = y.shape
    G = dxg.shape[-1]
    dev = y.device
    if dxg.dtype not in TRAIN_IO:
        raise ValueError(f"dxg dtype {dxg.dtype}: the kernel takes float32 or bfloat16 streams")
    _check_cuda("y", y, torch.float32, dev)
    _check_cuda("dxg", dxg, dxg.dtype, dev, (T, R, G))
    splits, chunk = dw_split_plan(T, R, H, G, dxg.dtype)
    dw = torch.empty(H, G, dtype=torch.float32, device=dev)
    part = dw if splits == 1 else torch.empty(splits, H, G, dtype=torch.float32, device=dev)
    lib = _lib("train_bwd")
    with torch.cuda.device(dev):
        rc = lib.gsu_train_dw_launch(TRAIN_IO[dxg.dtype], _ptr(y), _ptr(dxg), _ptr(dw),
                                     _ptr(part), T, R, H, G, splits, chunk, _stream())
    _check_rc(lib, rc, "gsu_train_dw")
    gsu_train_dw.launches += 1
    return dw


gsu_train_dw.launches = 0


def gsu_layer_train_bwd(xg: torch.Tensor, y: torch.Tensor, gout: torch.Tensor,
                        stats: torch.Tensor, whh: torch.Tensor, b2: torch.Tensor,
                        bnp: torch.Tensor, hidden: int, shared: bool, mode: str
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel D's backward (kernel E, then ``gsu_train_dw`` for dW): the
    inputs and saved tensors of ``gsu_layer_train_fwd`` and the spikes'
    gradient ``gout [T, R, H]`` in the stream type -> (dxg ``[T, R, G]`` in
    the stream type, dW ``[H, G]``, db ``[2, H]``, dbn ``[2, H]``, zero
    outside mode "bn", in the accumulation type). The statistics get no
    gradient (running statistics are not differentiated, as in torch's
    BatchNorm)."""
    if not xg.is_cuda:
        return layer_train_bwd_plain(xg, y, gout, stats, whh, b2, bnp, hidden, shared, mode)
    if mode == "affine":
        raise ValueError("kernel E takes mode 'bn' or 'none' (the affine mode is eval only)")
    H = hidden
    T, R, G = _check_train_layer(xg, whh, b2, bnp, H, shared, mode)
    dev, io = xg.device, xg.dtype
    _check_cuda("y", y, torch.float32, dev, (T, R, H))
    _check_cuda("gout", gout, io, dev, (T, R, H))
    _check_cuda("stats", stats, torch.float32, dev, (T, 2, H))
    dxg = torch.empty(T, R, G, dtype=io, device=dev)
    db = torch.empty(2, H, dtype=torch.float32, device=dev)
    dbn = torch.empty(2, H, dtype=torch.float32, device=dev)
    scratch = torch.zeros(4, R, H, dtype=torch.float32, device=dev)  # dh, dc, f, g
    whh_t = whh.t().contiguous()
    lib = _lib("train_bwd")
    with torch.cuda.device(dev):
        rc = lib.gsu_train_bwd_launch(
            TRAIN_IO[io], _ptr(xg), _ptr(y), _ptr(gout), _ptr(stats), _ptr(whh), _ptr(whh_t),
            _ptr(b2), _ptr(bnp), _ptr(dxg), _ptr(db), _ptr(dbn), _ptr(scratch), T, R, H,
            int(shared), TRAIN_MODES[mode], _stream())
    _check_rc(lib, rc, f"gsu_layer_train_bwd (H={H}, R={R})", TRAIN_LIMITS)
    gsu_layer_train_bwd.launches += 1
    return dxg, gsu_train_dw(y, dxg), db, dbn


gsu_layer_train_bwd.launches = 0


# ------------------------------------------------------------------ kernel B
#
# A section is a dict:
#   wa [n, aw, G]   layer-0 weights of each unit over xa[..., a0:a0+aw]
#   a0              first xa lane of the window
#   wb [n, Fb, G]   layer-0 weights of each unit over xb
#   uv [2, G]       (optional) the pre-LN fold's column sums u and bias
#                   projection v: the gates are alpha ck - beta u + v
#   wihr, whh, coef the section's stack (pack_stack)
#   wproj [H, P], bproj [P]   output projection, columns in (c, d, fc) order
#   ctr, df         unit centre width and deep-filter order (P = 2 df ctr)
# Units of section s write enhanced bins f0_s + j ctr + f, f0_s the running
# sum of the earlier sections' n ctr. The unit scales ``alpha`` are None (the
# gates are ck as they are), ``[B, U]`` (one per utterance and unit) or
# ``[T, B, U]`` (per frame); ``beta [T, B, U]`` goes with a per-frame alpha
# and is read by the sections that carry ``uv``.

ALPHA_MODES = {None: 0, 2: 1, 3: 2}  # alpha.ndim -> the launcher's alpha_mode


def _check_section_modes(secs: List[Dict[str, Any]], alpha: Optional[torch.Tensor],
                         beta: Optional[torch.Tensor], T: int, B: int, U: int) -> None:
    """Raises ValueError on a combination of unit scales and pre-LN terms
    that kernel B (and so its plain version) does not take."""
    ln = any("uv" in s for s in secs)
    if alpha is not None and tuple(alpha.shape) not in ((B, U), (T, B, U)):
        raise ValueError(f"alpha shape {tuple(alpha.shape)}: expected None, [{B}, {U}] or "
                         f"[{T}, {B}, {U}]")
    if (beta is not None) != ln:
        raise ValueError("beta goes with the sections that carry the pre-LN terms 'uv' "
                         f"({'some' if ln else 'none'} do, beta is "
                         f"{'None' if beta is None else 'given'})")
    if ln and (alpha is None or alpha.ndim != 3 or tuple(beta.shape) != tuple(alpha.shape)):
        raise ValueError("the pre-LN terms need a per-frame alpha and beta [T, B, U]")


def sections_eval_plain(secs: List[Dict[str, Any]], xa: torch.Tensor, xb: torch.Tensor,
                        alpha: Optional[torch.Tensor], spec_re: Optional[torch.Tensor],
                        spec_im: Optional[torch.Tensor], hidden: int, shared: bool,
                        beta: Optional[torch.Tensor] = None,
                        spike_counts: Optional[List[List[float]]] = None):
    """Plain PyTorch version of kernel B (same arguments and result).

    ``spike_counts``, when a list, receives one list per section of each
    layer's number of spikes over the run (as ``stack_eval_plain``)."""
    io = xa.dtype
    acc = acc_dtype_for(io)
    T, B, _ = xa.shape
    dev = xa.device
    U = sum(int(s["wa"].shape[0]) for s in secs)
    df_mode = spec_re is not None
    _check_section_modes(secs, alpha, beta, T, B, U)
    W = sum(int(s["wa"].shape[0]) * s["ctr"] for s in secs)
    if df_mode:
        out_re = torch.zeros(T, B, W, dtype=spec_re.dtype, device=dev)
        out_im = torch.zeros(T, B, W, dtype=spec_re.dtype, device=dev)
    projs = []
    u0 = f0 = 0
    for s in secs:
        n, aw = int(s["wa"].shape[0]), int(s["wa"].shape[1])
        a0, ctr, df = s["a0"], s["ctr"], s["df"]
        w = n * ctr
        wa, wb = s["wa"].to(acc), s["wb"].to(acc)
        wihr, whh, coef = s["wihr"].to(acc), s["whh"].to(acc), s["coef"].to(acc)
        wproj, bproj = s["wproj"].to(acc), s["bproj"].to(acc)
        uv = s["uv"].to(acc) if "uv" in s else None
        L = whh.shape[0]
        h = [torch.zeros(n * B, hidden, dtype=acc, device=dev) for _ in range(L)]
        c = [torch.zeros(n * B, hidden, dtype=acc, device=dev) for _ in range(L)]
        if df_mode:
            sr = spec_re[:, :, f0:f0 + w].reshape(T, B, n, ctr).permute(0, 2, 1, 3)  # [T, n, B, ctr]
            si = spec_im[:, :, f0:f0 + w].reshape(T, B, n, ctr).permute(0, 2, 1, 3)
        else:
            proj = torch.empty(n, T, B, int(wproj.shape[1]), dtype=io, device=dev)
        tot = torch.zeros(L, dtype=torch.float64, device=dev)
        for t in range(T):
            xg = (torch.einsum("bp,npg->nbg", xa[t, :, a0:a0 + aw].to(acc), wa)
                  + torch.einsum("bq,nqg->nbg", xb[t].to(acc), wb))  # ck [n, B, G]
            if alpha is not None:
                al = alpha if alpha.ndim == 2 else alpha[t]
                xg = al[:, u0:u0 + n].T.to(acc)[:, :, None] * xg
                if uv is not None:
                    xg = xg - beta[t, :, u0:u0 + n].T.to(acc)[:, :, None] * uv[0] + uv[1]
            _stack_layers_step(xg.reshape(n * B, -1), h, c, wihr, whh, coef, hidden, shared)
            if spike_counts is not None:
                tot += torch.stack([hk.sum(dtype=torch.float64) for hk in h])
            y = (h[-1] @ wproj + bproj).reshape(n, B, -1)
            if not df_mode:
                proj[:, t] = y.to(io)
                continue
            er = torch.zeros(n, B, ctr, dtype=out_re.dtype, device=dev)
            ei = torch.zeros_like(er)
            for d in range(df):
                tt = t - (df - 1 - d)  # the oldest frame pairs with tap 0
                if tt < 0:
                    continue
                cr = y[:, :, d * ctr:(d + 1) * ctr]
                ci = y[:, :, (df + d) * ctr:(df + d + 1) * ctr]
                er = er + (sr[tt] * cr - si[tt] * ci)
                ei = ei + (sr[tt] * ci + si[tt] * cr)
            out_re[t, :, f0:f0 + w] = er.permute(1, 0, 2).reshape(B, w)
            out_im[t, :, f0:f0 + w] = ei.permute(1, 0, 2).reshape(B, w)
        if spike_counts is not None:
            spike_counts.append(tot.tolist())
        if not df_mode:
            projs.append(proj)
        u0 += n
        f0 += w
    return (out_re, out_im) if df_mode else projs


def gsu_sections_eval(secs: List[Dict[str, Any]], xa: torch.Tensor, xb: torch.Tensor,
                      alpha: Optional[torch.Tensor], spec_re: Optional[torch.Tensor],
                      spec_im: Optional[torch.Tensor], hidden: int, shared: bool,
                      beta: Optional[torch.Tensor] = None):
    """All sub-band sections in one launch.

    xa ``[T, B, Fa]`` and xb ``[T, B, Fb]`` feature streams (io type); alpha
    None, ``[B, U]`` or ``[T, B, U]`` unit scales and beta ``[T, B, U]`` the
    pre-LN mean terms (f32; the block comment above); spec_re/spec_im ``[T,
    B, Fs]`` the noisy spectrum (f32). Returns the enhanced (re, im) ``[T, B,
    W]``, W = sum of n ctr over the sections, in the spectrum's type; with
    the spectrum None (no deep filter) each section's projection ``[n, T,
    B, P]`` in the io type, a list."""
    if not xa.is_cuda:
        return sections_eval_plain(secs, xa, xb, alpha, spec_re, spec_im, hidden, shared, beta)
    H = hidden
    G = H if shared else 2 * H
    io, dev = xa.dtype, xa.device
    f32 = torch.float32
    if io not in (f32, torch.bfloat16):
        raise ValueError(f"xa dtype {io}: the kernel takes float32 or bfloat16")
    if not 1 <= len(secs) <= 8 or not 1 <= H <= 512:
        raise ValueError(f"{len(secs)} sections, H={H}: the kernel takes 1..8 sections, H <= 512")
    T, B, Fa = xa.shape
    Fb = xb.shape[-1]
    U = sum(int(s["wa"].shape[0]) for s in secs)
    W = sum(int(s["wa"].shape[0]) * s["ctr"] for s in secs)
    L = secs[0]["whh"].shape[0]
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"L={L}: the kernel takes 1..{MAX_LAYERS} layers")
    df_mode = spec_re is not None
    if (spec_im is not None) != df_mode:
        raise ValueError("spec_re and spec_im: both or neither")
    _check_section_modes(secs, alpha, beta, T, B, U)
    _check_cuda("xa", xa, io, dev)
    _check_cuda("xb", xb, io, dev, (T, B, Fb))
    dummy = torch.zeros(1, dtype=f32, device=dev)
    if alpha is not None:
        _check_cuda("alpha", alpha, f32, dev)
    if beta is not None:
        _check_cuda("beta", beta, f32, dev)
    Fs = 0
    if df_mode:
        Fs = spec_re.shape[-1]
        _check_cuda("spec_re", spec_re, f32, dev, (T, B, Fs))
        _check_cuda("spec_im", spec_im, f32, dev, (T, B, Fs))
        if W > Fs:
            raise ValueError(f"sections cover {W} bins, the spectrum has {Fs}")

    kinds = ("wa", "wb", "wihr", "whh", "coef", "wproj", "bproj", "uv")
    flat: Dict[str, List[torch.Tensor]] = {k: [] for k in kinds}
    offs = {k: 0 for k in kinds}
    table = []
    u0 = f0 = o_proj = 0
    for i, s in enumerate(secs):
        n, aw = int(s["wa"].shape[0]), int(s["wa"].shape[1])
        P = int(s["wproj"].shape[1])
        if P != 2 * s["df"] * s["ctr"] or s["a0"] + aw > Fa:
            raise ValueError(f"section {i}: P={P}, window ({s['a0']}, {aw}) in Fa={Fa}")
        shapes = {"wa": (n, aw, G), "wb": (n, Fb, G), "wihr": (max(L - 1, 1), H, G),
                  "whh": (L, H, G), "coef": (L, 4, H), "wproj": (H, P), "bproj": (P,)}
        if "uv" in s:
            shapes["uv"] = (2, G)
        row = [n, s["a0"], aw, s["ctr"], s["df"], P, u0, f0, int("uv" in s)]
        for k in kinds:
            row.append(offs[k])
            if k not in shapes:
                continue
            dt = f32 if k in ("coef", "bproj", "uv") else io
            _check_cuda(f"section {i} {k}", s[k], dt, dev, shapes[k])
            flat[k].append(s[k].reshape(-1))
            offs[k] += s[k].numel()
        table.append(row + [o_proj])
        u0 += n
        f0 += n * s["ctr"]
        o_proj += n * T * B * P
    cat = {k: torch.cat(v) if v else dummy for k, v in flat.items()}
    tab = (ctypes.c_longlong * (18 * len(table)))(*[int(v) for r in table for v in r])
    if df_mode:
        out_re = torch.empty(T, B, W, dtype=f32, device=dev)
        out_im = torch.empty_like(out_re)
        out_proj = None
    else:
        out_re = out_im = None
        out_proj = torch.empty(o_proj, dtype=io, device=dev)
    opt = lambda t: ctypes.c_void_p(None) if t is None else _ptr(t)  # noqa: E731
    lib = _lib("sections")
    with torch.cuda.device(dev):
        rc = lib.gsu_sections_eval_launch(
            int(io == torch.bfloat16), len(secs), ctypes.cast(tab, ctypes.c_void_p),
            ALPHA_MODES[None if alpha is None else alpha.ndim], int(df_mode),
            _ptr(xa), _ptr(xb), opt(alpha), opt(beta), opt(spec_re), opt(spec_im),
            _ptr(cat["wa"]), _ptr(cat["wb"]), _ptr(cat["uv"]), _ptr(cat["wihr"]),
            _ptr(cat["whh"]), _ptr(cat["coef"]), _ptr(cat["wproj"]), _ptr(cat["bproj"]),
            opt(out_re), opt(out_im), opt(out_proj), T, B, Fa, Fb, Fs, U, W, H, L, int(shared),
            _stream())
    _check_rc(lib, rc, "gsu_sections_eval")
    gsu_sections_eval.launches += 1
    if df_mode:
        return out_re, out_im
    projs = []
    for row in table:
        n, P, o = row[0], row[5], row[-1]
        projs.append(out_proj[o:o + n * T * B * P].view(n, T, B, P))
    return projs


gsu_sections_eval.launches = 0


# ------------------------------------------------------------------ kernel C
#
# A monolith spec ``mono`` is a dict:
#   norm            "ln" (pre-LN folded into the layer-0 weights, per-frame
#                   statistics), "cum" (cumulative laplace norm: running
#                   sums) or "raw"
#   n_fft, hop      frame and hop length (n_fft = 4 hop, hann window)
#   eps, t_real     the norms' epsilon; frames t >= t_real leave the OLA
#   wdft [n_fft, 2 F1]   windowed DFT (cos | -sin), io type, F1 = n_fft/2 + 1
#   widft [2 F1, n_fft]  inverse DFT with the window over the COLA constant
#   sel_mag [F, U+1], sel_fb [Pfb, U+1]   statistics columns (acc type,
#                   None for "raw"): unit u's column is its unfold's bin
#                   counts over its width, column U the fullband input mean
#   fb              {"wa" [Fin, Gf], "uv" [2, Gf] ("ln"), "wihr", "whh",
#                   "coef" (pack_stack), "wproj" [Hf, Pfb], "bproj" [Pfb],
#                   "hidden": Hf}
#   secs            kernel B's section dicts plus "uv" [2, G] ("ln")
#   hidden, shared  the sub-band stacks' H and weight sharing
# The sections cover the bins [0, W) with W = F = n_fft/2; bin F (Nyquist)
# passes through.

NORMS = {"raw": 0, "ln": 1, "cum": 2}
LN_EPS = 1e-5
MAX_SEC = 8


def monolith_dft_matrices(n_fft: int, dtype: torch.dtype, device=None):
    """(wdft [n_fft, 2 F1], widft [2 F1, n_fft]) of kernel C: the periodic
    hann window folded into the DFT, and into the inverse DFT over the
    COLA constant 3/2 of a hop of n_fft/4 (``gsu_pallas.py:1936-1956``)."""
    nn = np.arange(n_fft)
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * nn / n_fft))
    kk = np.arange(n_fft // 2 + 1)
    ang = 2.0 * np.pi * nn[:, None] * kk / n_fft
    wdft = np.concatenate([np.cos(ang) * win[:, None], -np.sin(ang) * win[:, None]], axis=1)
    w_h = np.full((kk.size, 1), 2.0)
    w_h[0, 0] = w_h[-1, 0] = 1.0
    ang_i = ang.T
    widft = np.concatenate([w_h * np.cos(ang_i), -w_h * np.sin(ang_i)], axis=0) / n_fft
    widft = widft * (win[None, :] / 1.5)
    # rounded once from float64 (through float32, as the JAX package)
    to = lambda a: torch.as_tensor(a.astype(np.float32) if dtype != torch.float64 else a,  # noqa: E731
                                   device=device).to(dtype).contiguous()
    return to(wdft), to(widft)


def _mono_geometry(mono) -> Tuple[int, int, int]:
    """(U, W, F1) of a spec."""
    U = sum(int(s["wa"].shape[0]) for s in mono["secs"])
    W = sum(int(s["wa"].shape[0]) * s["ctr"] for s in mono["secs"])
    return U, W, mono["n_fft"] // 2 + 1


def monolith_serve_plain(mono: Dict[str, Any], chunks: torch.Tensor,
                         spike_counts: Optional[List[List[float]]] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel C (same arguments and result).

    chunks ``[S + 3, B, hop]`` (io type) -> ``[S, B, hop]`` in the
    accumulation type: step t reads chunks t..t+3 as its frame and emits the
    overlap-added samples [t hop, (t+1) hop). ``spike_counts``, when a list,
    receives the fullband stack's per-layer spike counts, then each
    section's."""
    io = chunks.dtype
    acc = acc_dtype_for(io)
    dev = chunks.device
    S, B, hop = chunks.shape[0] - 3, chunks.shape[1], chunks.shape[2]
    n_fft, norm, eps, t_real = mono["n_fft"], mono["norm"], mono["eps"], mono["t_real"]
    U, W, F1 = _mono_geometry(mono)
    F = F1 - 1
    H, shared = mono["hidden"], mono["shared"]
    f = lambda x: None if x is None else x.to(acc)  # noqa: E731
    wdft, widft = f(mono["wdft"]), f(mono["widft"])
    sel_mag, sel_fb = f(mono["sel_mag"]), f(mono["sel_fb"])
    fb = {k: f(v) if isinstance(v, torch.Tensor) else v for k, v in mono["fb"].items()}
    secs = [{k: f(v) if isinstance(v, torch.Tensor) else v for k, v in s.items()}
            for s in mono["secs"]]
    Hf, Fin = fb["hidden"], fb["wa"].shape[0]
    rnd = lambda x: x.to(io).to(acc)  # noqa: E731  (a stream rounded to the io type)

    def zeros(*shape):
        return torch.zeros(*shape, dtype=acc, device=dev)

    hf = [zeros(B, Hf) for _ in range(fb["whh"].shape[0])]
    cf = [zeros(B, Hf) for _ in hf]
    st = []
    for s in secs:
        n, L = s["wa"].shape[0], s["whh"].shape[0]
        st.append({"h": [zeros(n * B, H) for _ in range(L)], "c": [zeros(n * B, H) for _ in range(L)],
                   "ring": [], "tot": torch.zeros(L, dtype=torch.float64, device=dev)})
    tot_fb = torch.zeros(len(hf), dtype=torch.float64, device=dev)
    cum = zeros(B, U + 1)
    ola = [zeros(B, n_fft) for _ in range(3)]  # frames t-1, t-2, t-3
    ring = [chunks[0], chunks[1], chunks[2]]
    out = torch.empty(S, B, hop, dtype=acc, device=dev)
    for t in range(S):
        # ---- STFT frame, magnitude, statistics of the magnitude ----
        cur = chunks[t + 3]
        frame = torch.cat(ring + [cur], dim=1).to(acc)
        ring = ring[1:] + [cur]
        reim = frame @ wdft
        re, im = reim[:, :F1], reim[:, F1:]
        mag = torch.sqrt(torch.sqrt(re * re + im * im))
        mag_io = rnd(mag)
        inv_t = 1.0 / (t + 1)
        if norm != "raw":
            s1m = mag[:, :F] @ sel_mag
            if norm == "ln":
                s2m = (mag * mag)[:, :F] @ sel_mag
        # ---- fullband stack and projection ----
        xgf = mag_io[:, :Fin] @ fb["wa"]
        if norm == "ln":
            mu_f = s1m[:, U:U + 1]
            rstd_f = 1.0 / torch.sqrt((s2m[:, U:U + 1] - mu_f * mu_f) + LN_EPS)
            xgf = rstd_f * xgf - (rstd_f * mu_f) * fb["uv"][0] + fb["uv"][1]
        elif norm == "cum":
            xgf = xgf / ((cum[:, U:U + 1] + s1m[:, U:U + 1]) * inv_t + eps)
        _stack_layers_step(xgf, hf, cf, fb["wihr"], fb["whh"], fb["coef"], Hf, shared)
        if spike_counts is not None:
            tot_fb += torch.stack([h.sum(dtype=torch.float64) for h in hf])
        fb_y = hf[-1] @ fb["wproj"] + fb["bproj"]
        fb_io = rnd(fb_y)
        # ---- per-unit scales ----
        alpha = beta = None
        if norm == "ln":
            mu = s1m + fb_y @ sel_fb
            var = (s2m + (fb_y * fb_y) @ sel_fb) - mu * mu
            alpha = 1.0 / torch.sqrt(var + LN_EPS)
            beta = alpha * mu
        elif norm == "cum":
            cum = (cum + s1m) + fb_y @ sel_fb
            alpha = 1.0 / (cum * inv_t + eps)
        # ---- sections: gates, stacks, projection, deep filter ----
        er_parts, ei_parts = [], []
        u0 = f0 = 0
        for s, q in zip(secs, st):
            n, aw = s["wa"].shape[0], s["wa"].shape[1]
            a0, ctr, df = s["a0"], s["ctr"], s["df"]
            w = n * ctr
            xg = (torch.einsum("bp,npg->nbg", mag_io[:, a0:a0 + aw], s["wa"])
                  + torch.einsum("bq,nqg->nbg", fb_io, s["wb"]))
            if alpha is not None:
                xg = alpha[:, u0:u0 + n].T[:, :, None] * xg
                if norm == "ln":
                    xg = xg - beta[:, u0:u0 + n].T[:, :, None] * s["uv"][0] + s["uv"][1]
            _stack_layers_step(xg.reshape(n * B, -1), q["h"], q["c"], s["wihr"], s["whh"],
                               s["coef"], H, shared)
            if spike_counts is not None:
                q["tot"] += torch.stack([h.sum(dtype=torch.float64) for h in q["h"]])
            y = (q["h"][-1] @ s["wproj"] + s["bproj"]).reshape(n, B, -1)
            # ring[k] holds frame t-k; tap d pairs with frame t-(df-1-d)
            q["ring"] = ([(re[:, f0:f0 + w].reshape(B, n, ctr).transpose(0, 1),
                           im[:, f0:f0 + w].reshape(B, n, ctr).transpose(0, 1))]
                         + q["ring"])[:df]
            er = ei = None
            for d in range(df):
                k = df - 1 - d
                if k >= len(q["ring"]):
                    continue
                tr, tm = q["ring"][k]
                cr = y[:, :, d * ctr:(d + 1) * ctr]
                ci = y[:, :, (df + d) * ctr:(df + d + 1) * ctr]
                t_re, t_im = tr * cr - tm * ci, tr * ci + tm * cr
                er = t_re if er is None else er + t_re
                ei = t_im if ei is None else ei + t_im
            er_parts.append(er.transpose(0, 1).reshape(B, w))
            ei_parts.append(ei.transpose(0, 1).reshape(B, w))
            u0 += n
            f0 += w
        # ---- inverse DFT, overlap-add ----
        enh_re = rnd(torch.cat(er_parts + [re[:, W:]], dim=1))
        enh_im = rnd(torch.cat(ei_parts + [im[:, W:]], dim=1))
        if t < t_real:
            yf = enh_re @ widft[:F1] + enh_im @ widft[F1:]
        else:
            yf = zeros(B, n_fft)
        out[t] = (yf[:, :hop] + ola[0][:, hop:2 * hop] + ola[1][:, 2 * hop:3 * hop]
                  + ola[2][:, 3 * hop:])
        ola = [yf, ola[0], ola[1]]
    if spike_counts is not None:
        spike_counts.append(tot_fb.tolist())
        spike_counts.extend(q["tot"].tolist() for q in st)
    return out


# ---- kernel C's plan: the cluster's blocks, their shared memory, the packed
# weights. The kernel (csrc/sfsb_monolith_serve.cu) takes every offset from
# here, so that the CPU tests hold the plan the card runs.

# bytes of dynamic shared memory a block of kernel C can have on an H100
# (227 KB less the kernel's static profile counters)
SMEM_MAX = 232448 - 128
MONO_MAX_BLOCKS = 16  # blocks per cluster; above 8 the cluster is non-portable
MONO_MAX_N = 64  # columns (units x rows) of a unit block's products
ROLES = ("io", "fullband", "units")


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _ld(k: int) -> int:
    """Row length of a staged right operand of k summed inputs: whole
    16-wide k-tiles plus 8 (so that eight rows' fragments fall on 32
    distinct banks)."""
    return _r16(k) + 8


def _mono_dims(mono: Dict[str, Any]) -> Dict[str, Any]:
    fb, secs = mono["fb"], mono["secs"]
    U, W, F1 = _mono_geometry(mono)
    return dict(
        n_fft=mono["n_fft"], hop=mono["n_fft"] // 4, F1=F1, F=F1 - 1, W=W, U=U,
        Fin=int(fb["wa"].shape[0]), Pfb=int(fb["wproj"].shape[1]), Hf=fb["hidden"],
        Lf=int(fb["whh"].shape[0]), H=mono["hidden"], L=int(secs[0]["whh"].shape[0]),
        shared=bool(mono["shared"]), norm=mono["norm"],
        secs=[dict(n=int(s["wa"].shape[0]), a0=s["a0"], aw=int(s["wa"].shape[1]),
                   ctr=s["ctr"], df=s["df"], P=int(s["wproj"].shape[1])) for s in secs])


def _block_smem(d: Dict[str, Any], role: str, rt: int, es: int,
                unit: Optional[Tuple[int, int, int]] = None) -> Tuple[List[int], int]:
    """(region byte offsets, total bytes) of one block's shared memory; the
    regions in the order the kernel's stages name them (o[0], o[1], ...)."""
    n_fft, F1, F, U1, hop = d["n_fft"], d["F1"], d["F"], d["U"] + 1, d["hop"]
    Hp, Hfp = _r16(d["H"]), _r16(d["Hf"])
    if role == "io":  # front (DFT) and back (inverse DFT, overlap-add)
        sizes = [max(rt * _ld(n_fft) * es, F * rt * 4), 2 * F1 * rt * 4, F * U1 * 4,
                 2 * rt * _ld(2 * F1) * es, 4 * 2 * (F1 - d["W"]) * rt * 4, n_fft * rt * 4,
                 6 * hop * rt * 4]
    elif role == "fullband":
        sizes = [2 * rt * _ld(d["Fin"]) * es, 2 * 2 * U1 * rt * 4, 2 * d["Lf"] * rt * Hfp // 8,
                 d["Lf"] * Hfp * rt * 4, d["Pfb"] * rt * 4, d["Pfb"] * U1 * 4, U1 * rt * 4]
    else:
        si, _, nb = unit
        s = d["secs"][si]
        N = nb * rt
        sizes = [3 * rt * _ld(s["aw"]) * es, 2 * rt * _ld(d["Pfb"]) * es, 2 * 2 * nb * rt * 4,
                 (s["df"] + 2) * 2 * nb * s["ctr"] * rt * 4, 2 * d["L"] * N * Hp // 8,
                 d["L"] * Hp * N * 4, N * s["P"] * 4]
    offs, o = [], 0
    for n in sizes:
        offs.append(o)
        o += -(-n // 16) * 16
    return offs, o


def _unit_blocks(d: Dict[str, Any], rt: int, es: int) -> List[Tuple[int, int, int]]:
    """Unit blocks (section, first unit in the section, units): each holds
    units of one section only, at most MONO_MAX_N / rt, as few blocks as
    that allows (the fewer blocks a cluster has, the more clusters the card
    holds at once); a block over SMEM_MAX is split in two, while the cluster
    has room."""
    cap = MONO_MAX_N // rt
    blocks = []
    for si, s in enumerate(d["secs"]):
        k = -(-s["n"] // cap)
        sizes = [s["n"] // k + (1 if i < s["n"] % k else 0) for i in range(k)]
        jj = 0
        for nb in sizes:
            blocks.append((si, jj, nb))
            jj += nb
    while 2 + len(blocks) < MONO_MAX_BLOCKS:
        over = [i for i, b in enumerate(blocks)
                if b[2] > 1 and _block_smem(d, "units", rt, es, b)[1] > SMEM_MAX]
        if not over:
            break
        si, jj, nb = blocks[over[0]]
        blocks[over[0]:over[0] + 1] = [(si, jj, (nb + 1) // 2), (si, jj + (nb + 1) // 2, nb // 2)]
    return blocks


def monolith_plan(mono: Dict[str, Any], B: int, io: torch.dtype) -> Dict[str, Any]:
    """Kernel C's plan for a batch of B rows with ``io`` streams: rows per
    tile ``rt`` (16, else 8 where a block's shared memory needs it), the
    cluster's blocks (the io block: front and back of the pipeline; the
    fullband block; then the unit blocks, each one section's units), every
    block's shared-memory regions and total. Raises ValueError where no
    plan fits the card."""
    d = _mono_dims(mono)
    es = 2 if io == torch.bfloat16 else 4
    for rt in (16, 8):
        units = _unit_blocks(d, rt, es)
        blocks = []
        for role in ROLES[:2]:
            offs, total = _block_smem(d, role, rt, es)
            blocks.append(dict(role=role, sec=0, jj0=0, nb=0, o=offs, smem=total))
        for u in units:
            offs, total = _block_smem(d, "units", rt, es, u)
            blocks.append(dict(role="units", sec=u[0], jj0=u[1], nb=u[2], o=offs, smem=total))
        if len(blocks) <= MONO_MAX_BLOCKS and max(b["smem"] for b in blocks) <= SMEM_MAX:
            break
    else:
        raise ValueError(f"kernel C: no plan fits {SMEM_MAX} bytes of shared memory a block "
                         f"and {MONO_MAX_BLOCKS} blocks a cluster for this model "
                         f"({[(b['role'], b['smem']) for b in blocks]})")
    return dict(rt=rt, tiles=-(-B // rt), nblk=len(blocks), blocks=blocks,
                Hp=_r16(d["H"]), Hfp=_r16(d["Hf"]),
                ld_dft=_ld(d["n_fft"]), ld_fin=_ld(d["Fin"]), ld_pfb=_ld(d["Pfb"]),
                ld_idft=_ld(2 * d["F1"]), dims=d)


def _gate_perm(H: int, shared: bool) -> List[int]:
    """The gate columns in the order the kernel's accumulators take them
    (-1 a zero pad): shared, 16 units a tile; unshared, 8 units a tile with
    their f columns in rows 0-7 and their c columns (H + j) in rows 8-15."""
    if shared:
        return [j if j < H else -1 for j in range(_r16(H))]
    perm = []
    for q in range(-(-H // 8)):
        perm += [8 * q + r if 8 * q + r < H else -1 for r in range(8)]
        perm += [H + 8 * q + r if 8 * q + r < H else -1 for r in range(8)]
    return perm


def mma_a_fragments(a: torch.Tensor) -> torch.Tensor:
    """A [Mp, Kp] (multiples of 16) -> [Mp/16, Kp/16, 32, 8]: each 16 x 16
    tile as the 32 lanes' A fragments of mma.sync m16n8k16 (row-major A):
    lane (g, t) = (lane / 4, lane % 4) holds A[g][2t..2t+1], A[g+8][2t..],
    A[g][2t+8..], A[g+8][2t+8..] (registers a0-a3, low half first)."""
    Mp, Kp = a.shape
    a4 = a.reshape(Mp // 16, 16, Kp // 16, 16).permute(0, 2, 1, 3)
    lane = torch.arange(32)
    e = torch.arange(8)
    reg, half = e // 2, e % 2
    mi = (lane // 4)[:, None] + 8 * (reg % 2)[None, :]
    ki = (2 * (lane % 4))[:, None] + half[None, :] + 8 * (reg // 2)[None, :]
    return a4[:, :, mi.to(a.device), ki.to(a.device)]


def _pack_mat(w: torch.Tensor, kparts: Sequence[int], gate: Optional[Tuple[int, bool]],
              io: torch.dtype) -> Tuple[torch.Tensor, int, int]:
    """W [K, M] (K the concatenation of ``kparts``) as kernel C's left
    operand W^T: each part's rows padded to whole k-tiles, the columns in
    the gate order (``gate`` = (H, shared)) or padded to 16. bf16: mma A
    fragments; float32: [m-tiles][Kp][16]. Returns (flat, k-tiles, m-tiles)."""
    K, M = w.shape
    rows, o = [], 0
    for k in kparts:
        part = w[o:o + k]
        rows.append(torch.cat([part, part.new_zeros(_r16(k) - k, M)]))
        o += k
    wp = torch.cat(rows)
    perm = _gate_perm(*gate) if gate else list(range(M)) + [-1] * (_r16(M) - M)
    idx = torch.tensor([p if p >= 0 else M for p in perm], device=w.device)
    a = torch.cat([wp, wp.new_zeros(wp.shape[0], 1)], dim=1)[:, idx].T.contiguous()  # [Mp, Kp]
    Mp, Kp = a.shape
    if io == torch.bfloat16:
        flat = mma_a_fragments(a.to(io))
    else:
        flat = a.reshape(Mp // 16, 16, Kp).permute(0, 2, 1)
    return flat.reshape(-1), Kp // 16, Mp // 16


def monolith_pack(mono: Dict[str, Any], io: torch.dtype):
    """Every weight matrix of kernel C packed into one flat tensor of the
    io type: (flat, {name: (offset, k-tiles, m-tiles)}, per-unit layer-0
    matrix sizes per section). Names: dft, idft, fb_in, fb_rec{k},
    fb_proj, s{i}_rec{k}, s{i}_proj, s{i}_win{jj}."""
    fb, secs = mono["fb"], mono["secs"]
    H, Hf, shared = mono["hidden"], fb["hidden"], bool(mono["shared"])
    n_fft, F1 = mono["n_fft"], mono["n_fft"] // 2 + 1
    Fin, Pfb = int(fb["wa"].shape[0]), int(fb["wproj"].shape[1])
    mats = [("dft", mono["wdft"], [n_fft], None), ("idft", mono["widft"], [2 * F1], None),
            ("fb_in", fb["wa"], [Fin], (Hf, shared))]

    def stack(prefix, wihr, whh, h):
        out = [(f"{prefix}rec0", whh[0], [h], (h, shared))]
        for k in range(1, whh.shape[0]):
            out.append((f"{prefix}rec{k}", torch.cat([wihr[k - 1], whh[k]]), [h, h], (h, shared)))
        return out

    mats += stack("fb_", fb["wihr"], fb["whh"], Hf)
    mats.append(("fb_proj", fb["wproj"], [Hf], None))
    for i, s in enumerate(secs):
        mats += stack(f"s{i}_", s["wihr"], s["whh"], H)
        mats.append((f"s{i}_proj", s["wproj"], [H], None))
        aw = int(s["wa"].shape[1])
        for jj in range(int(s["wa"].shape[0])):
            mats.append((f"s{i}_win{jj}", torch.cat([s["wa"][jj], s["wb"][jj]]), [aw, Pfb],
                         (H, shared)))
    flats, table, off = [], {}, 0
    for name, w, kparts, gate in mats:
        flat, kt, mt = _pack_mat(w, kparts, gate, io)
        table[name] = (off, kt, mt)
        flats.append(flat)
        off += flat.numel()
    return torch.cat(flats), table


class _MonoMatC(ctypes.Structure):
    _fields_ = [("off", ctypes.c_longlong), ("kt", ctypes.c_int), ("mt", ctypes.c_int)]


class _MonoSecC(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_int) for k in ("n", "a0", "aw", "ctr", "df", "P", "u0", "f0",
                                              "dr", "ld_aw", "kt_aw")]
                + [("rec", _MonoMatC * 3), ("proj", _MonoMatC), ("win", _MonoMatC)]
                + [(k, ctypes.c_longlong) for k in ("win_size", "uv", "coef", "bproj")])


class _MonoBlkC(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_int) for k in ("sec", "jj0", "nb", "smem")]
                + [("o", ctypes.c_int * 8)])


_MONO_PTRS = ("chunks", "out", "w", "sel_mag", "sel_fb", "fb_uv", "fb_coef", "fb_bproj", "uv",
              "coef", "bproj", "prof")
_MONO_INTS = ("S", "B", "hop", "n_fft", "Fin", "Pfb", "U", "W", "H", "L", "Hf", "Lf", "shared",
              "norm", "t_real", "n_sec")
_MONO_PLAN = ("rt", "nblk", "Hp", "Hfp", "ld_dft", "ld_fin", "ld_pfb", "ld_idft")


class _MonoArgs(ctypes.Structure):
    """Mirror of ``MonoArgs`` in ``csrc/sfsb_monolith_serve.cu``."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _MONO_PTRS]
                + [(k, ctypes.c_int) for k in _MONO_INTS]
                + [("eps", ctypes.c_float)]
                + [(k, ctypes.c_int) for k in _MONO_PLAN]
                + [("dft", _MonoMatC), ("idft", _MonoMatC), ("fb_in", _MonoMatC),
                   ("fb_rec", _MonoMatC * 3), ("fb_proj", _MonoMatC),
                   ("sec", _MonoSecC * MAX_SEC), ("blk", _MonoBlkC * MONO_MAX_BLOCKS)])


def _set_mat(dst: _MonoMatC, entry: Tuple[int, int, int]) -> None:
    dst.off, dst.kt, dst.mt = entry


def _mono_launch_args(mono: Dict[str, Any], chunks: torch.Tensor):
    """Checks a spec and its chunks for the kernel and builds its launch
    arguments: (args, the tensors they point into, the plan, the library)."""
    io, dev = chunks.dtype, chunks.device
    if io not in (torch.float32, torch.bfloat16):
        raise ValueError(f"chunks dtype {io}: the kernel takes float32 or bfloat16")
    if chunks.ndim != 3 or chunks.shape[0] < 4:
        raise ValueError(f"chunks shape {tuple(chunks.shape)}: expected [S + 3, B, hop], S >= 1")
    secs, fb = mono["secs"], mono["fb"]
    S, B, hop = chunks.shape[0] - 3, chunks.shape[1], chunks.shape[2]
    n_fft, norm = mono["n_fft"], mono["norm"]
    H, shared, Hf = mono["hidden"], bool(mono["shared"]), fb["hidden"]
    G, Gf = (H, Hf) if shared else (2 * H, 2 * Hf)
    U, W, F1 = _mono_geometry(mono)
    F = F1 - 1
    L, Lf = secs[0]["whh"].shape[0], fb["whh"].shape[0]
    Fin, Pfb = fb["wa"].shape[0], fb["wproj"].shape[1]
    if norm not in NORMS or n_fft != 4 * hop or W != F or not 1 <= len(secs) <= MAX_SEC:
        raise ValueError(f"norm {norm!r}, n_fft {n_fft}, hop {hop}, {len(secs)} sections over "
                         f"{W} of {F} bins: the kernel takes ln/cum/raw, n_fft = 4 hop, "
                         f"1..{MAX_SEC} sections covering every bin but Nyquist")
    if not (1 <= L <= 3 and 1 <= Lf <= 3 and 1 <= H <= 512 and 1 <= Hf <= 512 and Fin <= F):
        raise ValueError(f"L={L}, Lf={Lf}, H={H}, Hf={Hf}, Fin={Fin}: the kernel takes 1..3 "
                         "layers per stack, H <= 512, Fin <= n_fft/2")
    _check_cuda("chunks", chunks, io, dev)
    _check_cuda("wdft", mono["wdft"], io, dev, (n_fft, 2 * F1))
    _check_cuda("widft", mono["widft"], io, dev, (2 * F1, n_fft))
    f32 = torch.float32
    dummy = torch.zeros(1, dtype=f32, device=dev)
    if norm == "raw":
        sel_mag = sel_fb = dummy
    else:
        sel_mag, sel_fb = mono["sel_mag"], mono["sel_fb"]
        _check_cuda("sel_mag", sel_mag, f32, dev, (F, U + 1))
        _check_cuda("sel_fb", sel_fb, f32, dev, (Pfb, U + 1))
    fb_shapes = {"wa": (io, (Fin, Gf)), "wihr": (io, (max(Lf - 1, 1), Hf, Gf)),
                 "whh": (io, (Lf, Hf, Gf)), "coef": (f32, (Lf, 4, Hf)),
                 "wproj": (io, (Hf, Pfb)), "bproj": (f32, (Pfb,))}
    if norm == "ln":
        fb_shapes["uv"] = (f32, (2, Gf))
    for k, (dt, shp) in fb_shapes.items():
        _check_cuda(f"fb {k}", fb[k], dt, dev, shp)
    for i, s in enumerate(secs):
        n, aw = int(s["wa"].shape[0]), int(s["wa"].shape[1])
        P = int(s["wproj"].shape[1])
        if P != 2 * s["df"] * s["ctr"] or s["a0"] + aw > F:
            raise ValueError(f"section {i}: P={P}, window ({s['a0']}, {aw}) in F={F}")
        shapes = {"wa": (io, (n, aw, G)), "wb": (io, (n, Pfb, G)),
                  "wihr": (io, (max(L - 1, 1), H, G)), "whh": (io, (L, H, G)),
                  "coef": (f32, (L, 4, H)), "wproj": (io, (H, P)), "bproj": (f32, (P,))}
        if norm == "ln":
            shapes["uv"] = (f32, (2, G))
        for k, (dt, shp) in shapes.items():
            _check_cuda(f"section {i} {k}", s[k], dt, dev, shp)

    plan = monolith_plan(mono, B, io)
    if "packed" not in mono:  # the weights are packed once a spec
        mono["packed"] = monolith_pack(mono, io)
    packed, table = mono["packed"]
    args = _MonoArgs()
    f_arr = {k: [] for k in ("uv", "coef", "bproj")}
    f_off = {k: 0 for k in f_arr}
    u0 = f0 = 0
    for i, s in enumerate(secs):
        sec = args.sec[i]
        n, aw = int(s["wa"].shape[0]), int(s["wa"].shape[1])
        sec.n, sec.a0, sec.aw, sec.ctr, sec.df, sec.P, sec.u0, sec.f0 = (
            n, s["a0"], aw, s["ctr"], s["df"], int(s["wproj"].shape[1]), u0, f0)
        sec.dr, sec.ld_aw, sec.kt_aw = s["df"] + 2, _ld(aw), _r16(aw) // 16
        for k in range(L):
            _set_mat(sec.rec[k], table[f"s{i}_rec{k}"])
        _set_mat(sec.proj, table[f"s{i}_proj"])
        _set_mat(sec.win, table[f"s{i}_win0"])
        sec.win_size = table[f"s{i}_win1"][0] - table[f"s{i}_win0"][0] if n > 1 else 0
        for k in f_arr:
            t = (s["uv"] if norm == "ln" else torch.zeros(2, G, dtype=f32, device=dev)
                 ) if k == "uv" else s[k]
            setattr(sec, k, f_off[k])
            f_arr[k].append(t.reshape(-1))
            f_off[k] += t.numel()
        u0 += n
        f0 += n * s["ctr"]
    cat = {k: torch.cat(v) for k, v in f_arr.items()}
    _set_mat(args.dft, table["dft"])
    _set_mat(args.idft, table["idft"])
    _set_mat(args.fb_in, table["fb_in"])
    for k in range(Lf):
        _set_mat(args.fb_rec[k], table[f"fb_rec{k}"])
    _set_mat(args.fb_proj, table["fb_proj"])
    for b, blk in enumerate(plan["blocks"]):
        dst = args.blk[b]
        dst.sec, dst.jj0, dst.nb, dst.smem = blk["sec"], blk["jj0"], blk["nb"], blk["smem"]
        for q, o in enumerate(blk["o"]):
            dst.o[q] = o
    out = torch.empty(S, B, hop, dtype=f32, device=dev)
    ptrs = {"chunks": chunks, "out": out, "w": packed, "sel_mag": sel_mag, "sel_fb": sel_fb,
            "fb_uv": fb["uv"] if norm == "ln" else dummy, "fb_coef": fb["coef"],
            "fb_bproj": fb["bproj"], "prof": None, **cat}
    for k in _MONO_PTRS:
        setattr(args, k, None if ptrs[k] is None else ptrs[k].data_ptr())
    for k, v in dict(S=S, B=B, hop=hop, n_fft=n_fft, Fin=Fin, Pfb=Pfb, U=U, W=W, H=H, L=L,
                     Hf=Hf, Lf=Lf, shared=int(shared), norm=NORMS[norm],
                     t_real=int(mono["t_real"]), n_sec=len(secs)).items():
        setattr(args, k, v)
    args.eps = float(mono["eps"])
    for k in _MONO_PLAN:
        setattr(args, k, plan[k])
    lib = _lib(f"monolith_{'bf16' if io == torch.bfloat16 else 'f32'}")
    return args, (out, ptrs), plan, lib


def monolith_occupancy(mono: Dict[str, Any], chunks: torch.Tensor) -> Dict[str, Any]:
    """Kernel C's plan for these chunks on this card: rows per tile, blocks
    per cluster, the clusters (row tiles) the batch needs, the clusters the
    card holds at once (cudaOccupancyMaxActiveClusters) and the waves."""
    args, _, plan, lib = _mono_launch_args(mono, chunks)
    n = ctypes.c_int(0)
    with torch.cuda.device(chunks.device):
        rc = lib.sfsb_monolith_max_clusters(int(chunks.dtype == torch.bfloat16),
                                            ctypes.byref(args), ctypes.byref(n))
    _check_rc(lib, rc, "sfsb_monolith_max_clusters")
    active = n.value
    return dict(rows_per_tile=plan["rt"], blocks_per_cluster=plan["nblk"],
                clusters=plan["tiles"], max_active_clusters=active,
                in_flight=min(active, plan["tiles"]),
                waves=-(-plan["tiles"] // active) if active else None,
                smem=[b["smem"] for b in plan["blocks"]],
                units=[(b["sec"], b["jj0"], b["nb"]) for b in plan["blocks"][2:]])


MONO_PHASES = {"io": ("frame", "DFT", "magnitude", "hand-offs and statistics",
                      "pass-through bins", "inverse DFT", "overlap-add"),
               "fullband": ("layer 0", "upper layers", "projection and hand-off",
                            "unit scales"),
               "units": ("layer 0", "upper layers", "projection", "deep filter")}


def monolith_profile(mono: Dict[str, Any], chunks: torch.Tensor) -> Dict[str, Any]:
    """One launch of kernel C with its stage counters on: for each role,
    the SM cycles a step spends in each phase (``MONO_PHASES``) and waiting
    at the cluster barrier, averaged over the steps and the row tiles (unit
    blocks: the slowest one of each tile). Counts as a launch."""
    args, (out, _keep), plan, lib = _mono_launch_args(mono, chunks)
    prof = torch.zeros(plan["tiles"] * plan["nblk"], 8, dtype=torch.int64, device=chunks.device)
    args.prof = prof.data_ptr()
    with torch.cuda.device(chunks.device):
        rc = lib.sfsb_monolith_launch(int(chunks.dtype == torch.bfloat16), ctypes.byref(args),
                                      _stream())
    _check_rc(lib, rc, "sfsb_monolith_serve (profiled)")
    sfsb_monolith_serve.launches += 1
    cyc = prof.view(plan["tiles"], plan["nblk"], 8).double().cpu() / (chunks.shape[0])
    res = {}
    for b, role in enumerate(ROLES[:2]):
        names = MONO_PHASES[role]
        res[role] = {n: cyc[:, b, j].mean().item() for j, n in enumerate(names)}
        res[role]["barrier wait"] = cyc[:, b, 7].mean().item()
    units = cyc[:, 2:]
    busy = units[:, :, :4].sum(-1)
    slow = busy.argmax(dim=1)
    pick = units[torch.arange(plan["tiles"]), slow]
    res["units"] = {n: pick[:, j].mean().item() for j, n in enumerate(MONO_PHASES["units"])}
    res["units"]["barrier wait"] = pick[:, 7].mean().item()
    res["units_busy_each"] = busy.mean(0).tolist()
    return res


def sfsb_monolith_serve(mono: Dict[str, Any], chunks: torch.Tensor) -> torch.Tensor:
    """The whole serving model in one launch: hop chunks ``[S + 3, B, hop]``
    of the left-padded audio (f32/bf16 on the card; also f64 on the CPU) ->
    enhanced chunks ``[S, B, hop]`` in the accumulation type (f32 on the
    card). The caller trims them and corrects the COLA edges. On the card
    the weights are packed for the kernel (``monolith_pack``) at the spec's
    first launch and kept on it as ``mono["packed"]``, so a spec's weights
    must not change after that; the cluster is laid out by ``monolith_plan``
    for the batch at every call."""
    if not chunks.is_cuda:
        return monolith_serve_plain(mono, chunks)
    args, (out, _keep), _, lib = _mono_launch_args(mono, chunks)
    with torch.cuda.device(chunks.device):
        rc = lib.sfsb_monolith_launch(int(chunks.dtype == torch.bfloat16), ctypes.byref(args),
                                      _stream())
    _check_rc(lib, rc, "sfsb_monolith_serve")
    sfsb_monolith_serve.launches += 1
    return out


sfsb_monolith_serve.launches = 0
