"""STFT / iSTFT (counterpart of ``spiking_fullsubnet_tpu/dsp/spectral.py``).

The serving path's time-major formulation: the STFT is one windowed-DFT
matrix product over the frames, the iSTFT one inverse-DFT product followed
by overlap-add. ``stft_complex``/``istft_complex`` are torch.stft's steps
written out, and ``stft``/``istft``/``make_stft_pair`` the reference's
``output_type``/``input_type`` surface over them. Conventions are torch.stft/istft's
(center=True, periodic hann, constant padding, onesided), as in the JAX
package. ``matmul_dtype`` rounds the matmul inputs to that type and
accumulates in the signal's own float type (bf16-in, f32-accumulate).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Periodic Hann window, identical to ``torch.hann_window(n)``."""
    w = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / n))
    return torch.as_tensor(w, dtype=dtype, device=device)


def num_frames(num_samples: int, n_fft: int, hop_length: int, center: bool = True) -> int:
    """Number of STFT frames for a given signal length."""
    t = num_samples + 2 * (n_fft // 2) if center else num_samples
    return 1 + (t - n_fft) // hop_length


def _pad_window(window: torch.Tensor, win_length: int, n_fft: int) -> torch.Tensor:
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = F.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def _rounded(x: torch.Tensor, matmul_dtype) -> torch.Tensor:
    """Round matmul inputs to ``matmul_dtype`` but keep x's type for the
    product, so the sum accumulates in full precision."""
    if matmul_dtype is None:
        return x
    return x.to(matmul_dtype).to(x.dtype)


def stft_real_imag_tmajor(
    y: torch.Tensor,  # [B, T_samples]
    n_fft: int,
    hop_length: int,
    win_length: int,
    *,
    center: bool = True,
    n_frames_out: Optional[int] = None,
    matmul_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """STFT as a time-major (real, imag) pair, each ``[T_frames, B, n_fft//2+1]``.

    ``n_frames_out`` computes more frames than the signal needs; the extra
    frames read zero padding."""
    if y.ndim != 2:
        raise ValueError(f"tmajor STFT expects [B, T], got ndim={y.ndim}")
    real = y.dtype
    window = _pad_window(hann_window(win_length, real, y.device), win_length, n_fft)
    if center:
        y = F.pad(y, (n_fft // 2, n_fft // 2))
    n = 1 + (y.shape[-1] - n_fft) // hop_length
    if n_frames_out is not None:
        if n_frames_out < n:
            raise ValueError(f"n_frames_out={n_frames_out} < natural frames {n}")
        n = n_frames_out
    need = (n - 1) * hop_length + n_fft
    if need > y.shape[-1]:
        y = F.pad(y, (0, need - y.shape[-1]))
    k = np.arange(n_fft // 2 + 1)
    ang = 2.0 * np.pi * np.arange(n_fft)[:, None] * k / n_fft
    cos_m = torch.as_tensor(np.cos(ang), dtype=real, device=y.device)
    msin_m = torch.as_tensor(-np.sin(ang), dtype=real, device=y.device)
    frames = y.unfold(-1, n_fft, hop_length)[:, :n].transpose(0, 1)  # [n, B, n_fft]
    frames = _rounded(frames, matmul_dtype)
    re = frames @ _rounded(window[:, None] * cos_m, matmul_dtype)
    im = frames @ _rounded(window[:, None] * msin_m, matmul_dtype)
    return re, im


def stft_complex(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                 *, center: bool = True, pad_mode: str = "constant",
                 normalized: bool = False) -> torch.Tensor:
    """Complex STFT with ``torch.stft`` conventions (periodic hann window in
    the signal's type, onesided; ``pad_mode`` "constant" or "reflect" for
    the centring, ``normalized`` scales by n_fft^-1/2): ``[..., T] -> [...,
    F, T_frames]`` (``dsp/spectral.py:120``, its FFT branch). torch.stft's
    own steps written out (the centring pad, the frames times the window,
    the real FFT), so that the gradient is deterministic on a card: there
    torch.stft's reflect padding sums its gradient with atomic adds."""
    if pad_mode not in ("constant", "reflect"):
        raise ValueError(f"Unsupported pad_mode: {pad_mode}")
    window = _pad_window(hann_window(win_length, y.dtype, y.device), win_length, n_fft)
    lead = y.shape[:-1]
    y = y.reshape(-1, y.shape[-1])
    if center:
        p = n_fft // 2
        if pad_mode == "constant":
            y = F.pad(y, (p, p))
        elif p >= y.shape[-1]:
            raise ValueError(f"reflect padding of {p} needs more than {y.shape[-1]} samples")
        else:
            y = torch.cat([y[:, 1:p + 1].flip(-1), y, y[:, -p - 1:-1].flip(-1)], dim=-1)
    frames = y.unfold(-1, n_fft, hop_length) * window  # [N, T_frames, n_fft]
    spec = torch.fft.rfft(frames, dim=-1, norm="ortho" if normalized else "backward")
    return spec.transpose(-1, -2).reshape(lead + spec.shape[-1:] + spec.shape[-2:-1])


def istft_complex(spec: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                  length: Optional[int] = None, *, center: bool = True) -> torch.Tensor:
    """Inverse STFT ``[..., F, T_frames]`` complex -> ``[..., T]``
    (``dsp/spectral.py:447``): inverse real DFT, a float32 hann window (as
    in the JAX package, whatever the spectrum's type), overlap-add and the
    division by the overlap-added squared window where it is not zero."""
    window = _pad_window(hann_window(win_length, torch.float32, spec.device), win_length, n_fft)
    frames = torch.fft.irfft(spec.transpose(-1, -2), n=n_fft, dim=-1)  # [..., T_frames, n_fft]
    window = window.to(frames.dtype)
    frames = frames * window
    n_frames = frames.shape[-2]
    t_full = n_fft + hop_length * (n_frames - 1)
    lead = frames.shape[:-2]
    out = overlap_add(frames, hop_length).reshape(-1, t_full)
    env = overlap_add((window ** 2).expand(n_frames, n_fft), hop_length)
    out = out / torch.where(env > 1e-11, env, torch.ones_like(env))
    pad = n_fft // 2 if center else 0
    if length is not None:
        end = pad + length
        if end > t_full:
            out = F.pad(out, (0, end - t_full))
        out = out[:, pad:end]
    else:
        out = out[:, pad:t_full - pad]
    return out.reshape(lead + out.shape[-1:])


def overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Overlap-add ``[..., T_frames, frame_len] -> [..., frame_len + hop*(T-1)]``."""
    *lead, n_frames, frame_len = frames.shape
    t_full = frame_len + hop_length * (n_frames - 1)
    flat = frames.reshape(-1, n_frames, frame_len).transpose(1, 2)  # [N, len, T]
    out = F.fold(flat, output_size=(1, t_full), kernel_size=(1, frame_len),
                 stride=(1, hop_length))
    return out.reshape(tuple(lead) + (t_full,))


def _irdft_matrices(n_fft: int, dtype, device):
    """``irfft(X) == X.real @ A + X.imag @ B`` (Hermitian weights folded in)."""
    f = n_fft // 2 + 1
    ang = 2.0 * np.pi * np.arange(f)[:, None] * np.arange(n_fft) / n_fft
    w = np.full((f, 1), 2.0)
    w[0, 0] = 1.0
    if n_fft % 2 == 0:
        w[-1, 0] = 1.0  # Nyquist bin counted once
    a = torch.as_tensor(w * np.cos(ang) / n_fft, dtype=dtype, device=device)
    b = torch.as_tensor(-w * np.sin(ang) / n_fft, dtype=dtype, device=device)
    return a, b


def istft_real_imag_tmajor(
    re: torch.Tensor,  # [T_frames, B, F]
    im: torch.Tensor,
    n_fft: int,
    hop_length: int,
    win_length: int,
    length: Optional[int] = None,
    *,
    center: bool = True,
    matmul_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Inverse STFT from time-major (real, imag) spectra -> ``[B, T]``.

    For the default hann window at a COLA hop the squared-window envelope is
    constant (3/2 at 75 % overlap) except on the first and last
    ``n_fft - hop`` samples: the constant is folded into the window and only
    those edge strips are rescaled. The window is float32, as in the JAX
    package, whatever the spectrum's type."""
    real = re.dtype
    dev = re.device
    window = _pad_window(hann_window(win_length, torch.float32, dev), win_length, n_fft)
    n_frames = re.shape[0]
    t_full = n_fft + hop_length * (n_frames - 1)

    edge = n_fft - hop_length
    env_np = None
    cola_const = False
    if win_length == n_fft and t_full > 2 * edge:
        # envelope in f64 numpy so the folded constant is exact in any type
        w_np = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
        env_np = np.zeros(t_full)
        for k in range(n_frames):
            env_np[k * hop_length:k * hop_length + n_fft] += w_np ** 2
        interior = env_np[edge:t_full - edge]
        cola_const = bool(np.allclose(interior, interior[0], rtol=1e-9))

    a, b = _irdft_matrices(n_fft, real, dev)
    frames = (_rounded(re, matmul_dtype) @ _rounded(a, matmul_dtype)
              + _rounded(im, matmul_dtype) @ _rounded(b, matmul_dtype))
    if cola_const:
        c0 = float(interior[0])
        frames = frames * (window.to(real) * (1.0 / c0))
        out = overlap_add(frames.transpose(0, 1), hop_length)
        fix_np = np.ones(t_full)
        safe = np.where(env_np > 1e-11, env_np, 1.0)
        fix_np[:edge] = c0 / safe[:edge]
        fix_np[t_full - edge:] = c0 / safe[t_full - edge:]
        out = out * torch.as_tensor(fix_np, dtype=out.dtype, device=dev)
    else:
        frames = frames * window.to(real)
        out = overlap_add(frames.transpose(0, 1), hop_length)
        wsq = (window.to(real) ** 2).expand(n_frames, n_fft)
        env = overlap_add(wsq, hop_length)
        env = torch.where(env > 1e-11, env, torch.ones_like(env))
        out = out / env

    pad = n_fft // 2 if center else 0
    if length is not None:
        end = pad + length
        if end > t_full:
            out = F.pad(out, (0, end - t_full))
        return out[:, pad:end]
    return out[:, pad:t_full - pad]


def frame_signal(y: torch.Tensor, frame_length: int, hop_length: int) -> torch.Tensor:
    """Overlapping frames ``[..., T] -> [..., n_frames, frame_length]``
    (``spectral.py:54``); the samples past the last whole frame are dropped."""
    return y.unfold(-1, frame_length, hop_length)


def mag_phase(complex_spec: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Magnitude and phase of a complex spectrogram (``spectral.py:361``)."""
    return complex_spec.abs(), complex_spec.angle()


def stft(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
         output_type: Optional[str] = None, **kwargs):
    """The reference's STFT surface (``spectral.py:366``): ``[B, T]`` or
    ``[B, C, T]`` through ``stft_complex`` (``kwargs`` go there) to
    ``(mag, phase)`` for ``"mag_phase"``, ``(real, imag)`` for
    ``"real_imag"``, the complex spectrum for ``"complex"``, and ``(mag,
    phase, real, imag)`` by default."""
    if y.ndim not in (2, 3):
        raise ValueError(f"Only single-/multi-channel signals supported, got ndim={y.ndim}")
    spec = stft_complex(y, n_fft, hop_length, win_length, **kwargs)
    if output_type == "mag_phase":
        return mag_phase(spec)
    if output_type == "real_imag":
        return spec.real, spec.imag
    if output_type == "complex":
        return spec
    return (*mag_phase(spec), spec.real, spec.imag)


def istft(feature: Union[torch.Tensor, Sequence[torch.Tensor]], n_fft: int, hop_length: int,
          win_length: int, length: Optional[int] = None, input_type: str = "complex"
          ) -> torch.Tensor:
    """The reference's iSTFT surface (``spectral.py:513``): a complex
    spectrum, ``(real, imag)`` or ``(mag, phase)`` through ``istft_complex``."""
    if input_type == "real_imag":
        spec = torch.complex(*feature)
    elif input_type == "complex":
        spec = feature
    elif input_type == "mag_phase":
        mag, phase = feature
        spec = torch.complex(mag * torch.cos(phase), mag * torch.sin(phase))
    else:
        raise ValueError(f"Unsupported input_type: {input_type}")
    return istft_complex(spec, n_fft, hop_length, win_length, length=length)


def make_stft_pair(n_fft: int, hop_length: int, win_length: int):
    """``(stft, istft)`` with the frame sizes bound (``spectral.py:535``)."""
    return (partial(stft, n_fft=n_fft, hop_length=hop_length, win_length=win_length),
            partial(istft, n_fft=n_fft, hop_length=hop_length, win_length=win_length))
