"""ctypes bindings of the native WAV codec and batch reader (``wavio.cpp``;
counterpart of ``spiking_fullsubnet_tpu/native/wavio.py``).

Build: at first use ``$CXX`` (default ``g++``) compiles ``wavio.cpp`` with
``-O3 -shared -fPIC -std=c++17 -pthread`` into the git-ignored
``spiking_fullsubnet_torch/_build/``, the library named by the hash of the
source and the flags (as ``ops/gsu_kernels.py`` names the CUDA kernels), so
an edit of the source builds anew. ``native_available()`` is False only
where there is no compiler, and the log says so; a compiler that fails, or
a library that does not load, raises. Nothing turns to another reader
quietly.

``read_batch`` fills a whole ``[N, T]`` float32 training batch from one
call, a ``std::thread`` pool seeking to and decoding each file's crop: the
host-side counterpart of the reference's DataLoader workers
(dataloader.py num_workers), without pickling or processes.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).with_name("wavio.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
ERRORS = {
    -1: "cannot open file",
    -2: "unsupported or malformed WAV",
    -3: "seek failed",
    -4: "short read",
    -5: "write failed",
    -6: "bad arguments",
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def lib_path() -> Path:
    """Where the library for this source and these flags lives."""
    h = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libwavio_{h.hexdigest()[:12]}.so"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, L = ctypes.POINTER, ctypes.c_int, ctypes.c_long
    F = ctypes.c_float
    lib.sfs_wav_info.argtypes = [ctypes.c_char_p] + [P(t) for t in (I, L, I, I, I)]
    lib.sfs_wav_read.argtypes = [ctypes.c_char_p, L, L, P(F), P(I), P(I), P(L), P(L)]
    lib.sfs_wav_read_batch.argtypes = [P(ctypes.c_char_p), I, P(L), L, I, P(F), I, P(I)]
    lib.sfs_wav_write.argtypes = [ctypes.c_char_p, P(F), L, I, I, I]
    for fn in (lib.sfs_wav_info, lib.sfs_wav_read, lib.sfs_wav_read_batch, lib.sfs_wav_write):
        fn.restype = I
    return lib


def _build(cxx: str) -> ctypes.CDLL:
    out = lib_path()
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native wavio: {' '.join(cmd)} failed (rc {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return _bind(ctypes.CDLL(str(out)))


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            cxx = _compiler()
            if cxx is None:
                logger.warning("native wavio: no C++ compiler ($CXX or g++) on PATH; the "
                               "native reader is unavailable")
            else:
                _LIB = _build(cxx)
            _TRIED = True
    return _LIB


def native_available() -> bool:
    """True once the library is built and loaded; False only without a
    compiler. A failed build raises."""
    return _lib() is not None


def _need() -> ctypes.CDLL:
    lib = _lib()
    if lib is None:
        raise RuntimeError("native wavio: no C++ compiler ($CXX or g++) to build wavio.cpp")
    return lib


def _check(rc: int, path="") -> None:
    if rc != 0:
        raise IOError(f"native wavio: {ERRORS.get(rc, rc)} ({path})")


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def wav_info(path) -> Tuple[int, int, int, int, int]:
    """(sample_rate, frames, channels, bits, format) of a WAV file
    (format 1 PCM, 3 IEEE float)."""
    lib = _need()
    sr, frames, ch, bits, fmt = (ctypes.c_int(), ctypes.c_long(), ctypes.c_int(),
                                 ctypes.c_int(), ctypes.c_int())
    _check(lib.sfs_wav_info(str(path).encode(), sr, frames, ch, bits, fmt), path)
    return sr.value, frames.value, ch.value, bits.value, fmt.value


def wav_read(path, offset: int = 0, frames: int = -1,
             pad_to: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """A float32 window ``[T]`` (mono) or ``[C, T]`` and the sample rate.
    ``frames=-1`` reads to the end; the tail past the end, and up to
    ``pad_to`` frames, is zeros (the training-crop contract of
    ``dsp/io.subsample``)."""
    lib = _need()
    _, total, ch, _, _ = wav_info(path)
    want = max((total - offset) if frames < 0 else frames, 0)
    alloc = max(want, pad_to or 0)
    out = np.zeros(alloc * ch, dtype=np.float32)
    sr, chans, got, tot = ctypes.c_int(), ctypes.c_int(), ctypes.c_long(), ctypes.c_long()
    _check(lib.sfs_wav_read(str(path).encode(), offset, want, _fptr(out), sr, chans, got, tot),
           path)
    y = out.reshape(alloc, ch)
    y = y[:, 0] if ch == 1 else y.T
    return np.ascontiguousarray(y), sr.value


def read_batch(paths: Sequence, offsets: Sequence[int], frames: int,
               num_threads: int = 8) -> np.ndarray:
    """Crops of mono files read by a thread pool in one call: ``[N,
    frames]`` float32, zero past each file's end."""
    lib = _need()
    n = len(paths)
    if n == 0:
        return np.zeros((0, frames), np.float32)
    offs = np.asarray(offsets, dtype=np.int64)
    if offs.shape != (n,):
        raise ValueError(f"offsets: shape {offs.shape}, expected ({n},)")
    enc = [str(p).encode() for p in paths]  # held while the native call reads them
    arr = (ctypes.c_char_p * n)(*enc)
    out = np.zeros((n, frames), dtype=np.float32)
    rcs = np.zeros(n, dtype=np.int32)
    rc = lib.sfs_wav_read_batch(
        ctypes.cast(arr, ctypes.POINTER(ctypes.c_char_p)), n,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), frames, 1, _fptr(out), num_threads,
        rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    if rc != 0:
        bad = [str(paths[i]) for i in np.nonzero(rcs)[0][:3]]
        raise IOError(f"native wavio batch read failed ({ERRORS.get(rc, rc)}): {bad}")
    return out


def wav_write(path, data: np.ndarray, sr: int, as_float: bool = False) -> None:
    """Write ``[T]`` or ``[C, T]`` as PCM16 (rounded, clipped to [-1, 1]) or
    IEEE float32."""
    lib = _need()
    y = np.asarray(data, dtype=np.float32)
    if y.ndim == 1:
        frames, ch, inter = y.shape[0], 1, np.ascontiguousarray(y)
    else:
        (ch, frames), inter = y.shape, np.ascontiguousarray(y.T)
    _check(lib.sfs_wav_write(str(path).encode(), _fptr(inter), frames, ch, int(sr),
                             int(as_float)), path)
