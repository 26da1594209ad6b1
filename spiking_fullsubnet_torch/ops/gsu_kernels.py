"""Hopper kernels of the GSU serving path, their plain PyTorch versions and
their loader (counterpart of ``spiking_fullsubnet_tpu/ops/gsu_pallas.py``).

Two kernels, each a hand-written CUDA C++ source under ``../csrc``:

- ``gsu_stack_eval`` (kernel A, ``csrc/gsu_stack_eval.cu``) replaces
  ``_stack_eval_xg_kernel`` / ``gsu_stack_eval_pallas_xg``: an L-layer GSU
  stack in eval mode with the layer-0 gates given.
- ``gsu_sections_eval`` (kernel B, ``csrc/gsu_sections_eval.cu``) replaces
  ``_sections_kernel`` / ``gsu_sections_eval_pallas`` in its deep-filter
  mode: all sub-band sections, their projection and the deep filter.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; a CUDA tensor never takes the plain path. Each wrapper
counts its launches in ``<wrapper>.launches``. The plain versions are
public (``stack_eval_plain``, ``sections_eval_plain``), accept float64 and
are the kernels' oracles.

The kernels are compiled at first use with ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared`` (one nvcc per source, started
together) into ``spiking_fullsubnet_torch/_build/`` and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from .gsu import acc_dtype_for, bn_eval_affine

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = {"stack": "gsu_stack_eval.cu", "sections": "gsu_sections_eval.cu"}
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
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(SOURCES[name]).stem}_{h.hexdigest()[:12]}.so"


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
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {SOURCES[name]} (rc {proc.returncode}):\n{log}")
        os.replace(tmp, out)
    for name in todo:
        _LIBS[name] = _bind(name, ctypes.CDLL(str(_lib_path(name))))
    return time.perf_counter() - t0


def _bind(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I = ctypes.c_void_p, ctypes.c_int
    if name == "stack":
        lib.gsu_stack_eval_launch.argtypes = [I, P, P, P, P, P, I, I, I, I, I, I, I, P]
        lib.gsu_stack_eval_launch.restype = I
    else:
        lib.gsu_sections_eval_launch.argtypes = (
            [I, I, P] + [P] * 14 + [I] * 10 + [P])
        lib.gsu_sections_eval_launch.restype = I
    lib.gsu_error_string.argtypes = [I]
    lib.gsu_error_string.restype = ctypes.c_char_p
    return lib


def _lib(name: str) -> ctypes.CDLL:
    if name not in _LIBS:
        build_kernels()
    return _LIBS[name]


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
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


def stack_eval_plain(xg0: torch.Tensor, wihr: torch.Tensor, whh: torch.Tensor,
                     coef: torch.Tensor, hidden: int, shared: bool,
                     collect_all: bool = False,
                     spike_counts: Optional[List[float]] = None) -> torch.Tensor:
    """Plain PyTorch version of kernel A (same arguments and result).

    ``spike_counts``, when a list, receives each layer's number of spikes
    over the whole run: the nonzero inputs of the spike products, from
    which a caller counts the operations the data needs."""
    units = xg0.ndim == 4
    io = xg0.dtype
    acc = acc_dtype_for(io)
    x = xg0.transpose(0, 1) if units else xg0  # [T, (U,) R, G]
    T, G = x.shape[0], x.shape[-1]
    lead = x.shape[1:-1]
    x = x.reshape(T, -1, G)
    R = x.shape[1]
    L = whh.shape[0]
    wihr_a, whh_a, coef_a = wihr.to(acc), whh.to(acc), coef.to(acc)
    h = [torch.zeros(R, hidden, dtype=acc, device=x.device) for _ in range(L)]
    c = [torch.zeros(R, hidden, dtype=acc, device=x.device) for _ in range(L)]
    out = torch.empty((L if collect_all else 1, T, R, hidden), dtype=io, device=x.device)
    tot = torch.zeros(L, dtype=torch.float64, device=x.device)
    for t in range(T):
        _stack_layers_step(x[t].to(acc), h, c, wihr_a, whh_a, coef_a, hidden, shared)
        if spike_counts is not None:
            tot += torch.stack([hk.sum(dtype=torch.float64) for hk in h])
        if collect_all:
            for k in range(L):
                out[k, t] = h[k].to(io)
        else:
            out[0, t] = h[-1].to(io)
    if spike_counts is not None:
        spike_counts.extend(tot.tolist())
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


# ------------------------------------------------------------------ kernel B
#
# A section is a dict:
#   wa [n, aw, G]   layer-0 weights of each unit over xa[..., a0:a0+aw]
#   a0              first xa lane of the window
#   wb [n, Fb, G]   layer-0 weights of each unit over xb
#   wihr, whh, coef the section's stack (pack_stack)
#   wproj [H, P], bproj [P]   output projection, columns in (c, d, fc) order
#   ctr, df         unit centre width and deep-filter order (P = 2 df ctr)
# Units of section s write enhanced bins f0_s + j ctr + f, f0_s the running
# sum of the earlier sections' n ctr.


def sections_eval_plain(secs: List[Dict[str, Any]], xa: torch.Tensor, xb: torch.Tensor,
                        alpha: torch.Tensor, spec_re: torch.Tensor, spec_im: torch.Tensor,
                        hidden: int, shared: bool,
                        spike_counts: Optional[List[List[float]]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B (same arguments and result).

    ``spike_counts``, when a list, receives one list per section of each
    layer's number of spikes over the run (as ``stack_eval_plain``)."""
    io = xa.dtype
    acc = acc_dtype_for(io)
    T, B, _ = xa.shape
    dev = xa.device
    W = sum(int(s["wa"].shape[0]) * s["ctr"] for s in secs)
    out_re = torch.zeros(T, B, W, dtype=spec_re.dtype, device=dev)
    out_im = torch.zeros(T, B, W, dtype=spec_re.dtype, device=dev)
    u0 = f0 = 0
    for s in secs:
        n, aw = int(s["wa"].shape[0]), int(s["wa"].shape[1])
        a0, ctr, df = s["a0"], s["ctr"], s["df"]
        w = n * ctr
        wa, wb = s["wa"].to(acc), s["wb"].to(acc)
        wihr, whh, coef = s["wihr"].to(acc), s["whh"].to(acc), s["coef"].to(acc)
        wproj, bproj = s["wproj"].to(acc), s["bproj"].to(acc)
        al = alpha[:, u0:u0 + n].T.to(acc)[:, :, None]  # [n, B, 1]
        L = whh.shape[0]
        h = [torch.zeros(n * B, hidden, dtype=acc, device=dev) for _ in range(L)]
        c = [torch.zeros(n * B, hidden, dtype=acc, device=dev) for _ in range(L)]
        sr = spec_re[:, :, f0:f0 + w].reshape(T, B, n, ctr).permute(0, 2, 1, 3)  # [T, n, B, ctr]
        si = spec_im[:, :, f0:f0 + w].reshape(T, B, n, ctr).permute(0, 2, 1, 3)
        tot = torch.zeros(L, dtype=torch.float64, device=dev)
        for t in range(T):
            ck = (torch.einsum("bp,npg->nbg", xa[t, :, a0:a0 + aw].to(acc), wa)
                  + torch.einsum("bq,nqg->nbg", xb[t].to(acc), wb))
            _stack_layers_step((al * ck).reshape(n * B, -1), h, c, wihr, whh, coef,
                               hidden, shared)
            if spike_counts is not None:
                tot += torch.stack([hk.sum(dtype=torch.float64) for hk in h])
            y = (h[-1] @ wproj + bproj).reshape(n, B, -1)
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
        u0 += n
        f0 += w
    return out_re, out_im


def gsu_sections_eval(secs: List[Dict[str, Any]], xa: torch.Tensor, xb: torch.Tensor,
                      alpha: torch.Tensor, spec_re: torch.Tensor, spec_im: torch.Tensor,
                      hidden: int, shared: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """All sub-band sections with the deep filter, in one launch.

    xa ``[T, B, Fa]`` and xb ``[T, B, Fb]`` feature streams (io type), alpha
    ``[B, U]`` per-utterance unit scales (f32), spec_re/spec_im ``[T, B, Fs]``
    the noisy spectrum (f32). Returns the enhanced (re, im) ``[T, B, W]``,
    W = sum of n ctr over the sections, in the spectrum's type."""
    if not xa.is_cuda:
        return sections_eval_plain(secs, xa, xb, alpha, spec_re, spec_im, hidden, shared)
    H = hidden
    G = H if shared else 2 * H
    io, dev = xa.dtype, xa.device
    if io not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xa dtype {io}: the kernel takes float32 or bfloat16")
    if not 1 <= len(secs) <= 8 or not 1 <= H <= 512:
        raise ValueError(f"{len(secs)} sections, H={H}: the kernel takes 1..8 sections, H <= 512")
    T, B, Fa = xa.shape
    Fb = xb.shape[-1]
    Fs = spec_re.shape[-1]
    U = sum(int(s["wa"].shape[0]) for s in secs)
    W = sum(int(s["wa"].shape[0]) * s["ctr"] for s in secs)
    L = secs[0]["whh"].shape[0]
    if not 1 <= L <= MAX_LAYERS:
        raise ValueError(f"L={L}: the kernel takes 1..{MAX_LAYERS} layers")
    _check_cuda("xa", xa, io, dev)
    _check_cuda("xb", xb, io, dev, (T, B, Fb))
    _check_cuda("alpha", alpha, torch.float32, dev, (B, U))
    _check_cuda("spec_re", spec_re, torch.float32, dev, (T, B, Fs))
    _check_cuda("spec_im", spec_im, torch.float32, dev, (T, B, Fs))
    if W > Fs:
        raise ValueError(f"sections cover {W} bins, the spectrum has {Fs}")

    flat: Dict[str, List[torch.Tensor]] = {k: [] for k in (
        "wa", "wb", "wihr", "whh", "coef", "wproj", "bproj")}
    offs = {k: 0 for k in flat}
    table = []
    u0 = f0 = 0
    for i, s in enumerate(secs):
        n, aw = int(s["wa"].shape[0]), int(s["wa"].shape[1])
        P = int(s["wproj"].shape[1])
        if P != 2 * s["df"] * s["ctr"] or s["a0"] + aw > Fa:
            raise ValueError(f"section {i}: P={P}, window ({s['a0']}, {aw}) in Fa={Fa}")
        shapes = {"wa": (n, aw, G), "wb": (n, Fb, G), "wihr": (max(L - 1, 1), H, G),
                  "whh": (L, H, G), "coef": (L, 4, H), "wproj": (H, P), "bproj": (P,)}
        row = [n, s["a0"], aw, s["ctr"], s["df"], P, u0, f0]
        for k, shp in shapes.items():
            dt = torch.float32 if k in ("coef", "bproj") else io
            _check_cuda(f"section {i} {k}", s[k], dt, dev, shp)
            row.append(offs[k])
            flat[k].append(s[k].reshape(-1))
            offs[k] += s[k].numel()
        table.append(row)
        u0 += n
        f0 += n * s["ctr"]
    cat = {k: torch.cat(v) for k, v in flat.items()}
    tab = (ctypes.c_longlong * (15 * len(table)))(*[int(v) for r in table for v in r])
    out_re = torch.empty(T, B, W, dtype=torch.float32, device=dev)
    out_im = torch.empty_like(out_re)
    lib = _lib("sections")
    with torch.cuda.device(dev):
        rc = lib.gsu_sections_eval_launch(
            int(io == torch.bfloat16), len(secs), ctypes.cast(tab, ctypes.c_void_p),
            _ptr(xa), _ptr(xb), _ptr(alpha), _ptr(spec_re), _ptr(spec_im),
            _ptr(cat["wa"]), _ptr(cat["wb"]), _ptr(cat["wihr"]), _ptr(cat["whh"]),
            _ptr(cat["coef"]), _ptr(cat["wproj"]), _ptr(cat["bproj"]),
            _ptr(out_re), _ptr(out_im), T, B, Fa, Fb, Fs, U, W, H, L, int(shared), _stream())
    _check_rc(lib, rc, "gsu_sections_eval")
    gsu_sections_eval.launches += 1
    return out_re, out_im


gsu_sections_eval.launches = 0
