"""The port's native WAV codec (native/wavio.py, its own wavio.cpp) against
scipy and the JAX package's reader, bit for bit; its build; and the port's
DNS dataset and ``save_wav`` on it.

Mirrors tests/test_native_wavio.py and tests/test_dns_audio_native.py: PCM
16/24/32 and float32 reads equal scipy's values exactly, windows and the
zero padding past the end, the threaded batch read, the writer, the error
codes; every read also equal to the JAX package's reader. The DNS dataset's
crop-window path equals its read-whole-and-crop path and the JAX dataset,
train and eval, on a file shorter and one longer than 30 s.
"""

from __future__ import annotations

import struct

import numpy as np
import pytest
from scipy.io import wavfile

from spiking_fullsubnet_tpu.native import wavio as jwavio

from spiking_fullsubnet_torch.native import wavio


@pytest.fixture()
def tone():
    t = np.arange(16000, dtype=np.float32) / 16000.0
    return (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)


def _both(fn, *args, **kw):
    """The port's result, held equal to the JAX package's."""
    got, ref = getattr(wavio, fn)(*args, **kw), getattr(jwavio, fn)(*args, **kw)
    if isinstance(got, tuple):
        np.testing.assert_array_equal(got[0], ref[0])
        assert got[1:] == ref[1:]
    else:
        np.testing.assert_array_equal(got, ref)
    return got


def test_builds_into_the_port_build_dir():
    assert wavio.native_available()
    path = wavio.lib_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "spiking_fullsubnet_torch"
    # the port keeps its own copy of the source
    assert wavio.SRC.parent.parent.name == "spiking_fullsubnet_torch"


def test_failed_build_raises_and_no_compiler_is_unavailable(tmp_path, monkeypatch):
    bad = tmp_path / "wavio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(wavio, "SRC", bad)
    monkeypatch.setattr(wavio, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(wavio, "_LIB", None)
    monkeypatch.setattr(wavio, "_TRIED", False)
    with pytest.raises(RuntimeError, match="failed"):
        wavio.native_available()
    monkeypatch.setattr(wavio, "_TRIED", False)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    assert not wavio.native_available()
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        wavio.wav_read(tmp_path / "x.wav")


def test_pcm16_matches_scipy_and_jax(tmp_path, tone):
    p = tmp_path / "a.wav"
    wavfile.write(str(p), 16000, (tone * 32767.0).astype(np.int16))
    y, sr = _both("wav_read", p)
    assert sr == 16000
    np.testing.assert_array_equal(y, (wavfile.read(str(p))[1] / 32768.0).astype(np.float32))
    assert _both("wav_info", p) == (16000, 16000, 1, 16, 1)


def test_float32_and_int32_formats(tmp_path, tone):
    pf = tmp_path / "f32.wav"
    wavfile.write(str(pf), 8000, tone)
    np.testing.assert_array_equal(_both("wav_read", pf)[0], tone)
    pi = tmp_path / "i32.wav"
    wavfile.write(str(pi), 8000, (tone * 2147483647.0).astype(np.int32))
    np.testing.assert_array_equal(_both("wav_read", pi)[0],
                                  (wavfile.read(str(pi))[1] / 2147483648.0).astype(np.float32))


def test_pcm24_and_stereo(tmp_path, tone):
    s32 = (tone[:1000] * 2147483647.0).astype(np.int32)
    data = b"".join(bytes((((int(v) & 0xFFFFFFFF) >> s) & 0xFF for s in (8, 16, 24)))
                    for v in s32)
    p = tmp_path / "p24.wav"
    p.write_bytes(b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVEfmt "
                  + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 16000 * 3, 3, 24)
                  + b"data" + struct.pack("<I", len(data)) + data)
    y, _ = _both("wav_read", p)
    np.testing.assert_array_equal(y, (((s32 >> 8) << 8) / 2147483648.0).astype(np.float32))
    st = tmp_path / "st.wav"
    wavfile.write(str(st), 16000, (np.stack([tone, -tone], 1) * 32767.0).astype(np.int16))
    y, _ = _both("wav_read", st)
    np.testing.assert_array_equal(y, (wavfile.read(str(st))[1].T / 32768.0).astype(np.float32))


def test_windows_and_padding(tmp_path, tone):
    p = tmp_path / "w.wav"
    wavfile.write(str(p), 16000, (tone * 32767.0).astype(np.int16))
    full, _ = _both("wav_read", p)
    np.testing.assert_array_equal(_both("wav_read", p, offset=1000, frames=500)[0],
                                  full[1000:1500])
    y, _ = _both("wav_read", p, offset=15900, frames=500)
    np.testing.assert_array_equal(y[:100], full[15900:])
    assert (y[100:] == 0).all()
    y, _ = _both("wav_read", p, frames=20000, pad_to=24000)
    assert y.shape == (24000,) and (y[16000:] == 0).all()


def test_read_batch_equals_scipy_crops(tmp_path, tone):
    paths, offsets = [], []
    for i in range(6):
        p = tmp_path / f"b{i}.wav"
        wavfile.write(str(p), 16000, (np.roll(tone, i * 17) * 32767.0).astype(np.int16))
        paths.append(p)
        offsets.append(i * 2500)  # the last crops run past the end
    out = _both("read_batch", paths, offsets, frames=4000, num_threads=4)
    assert out.shape == (6, 4000) and out.dtype == np.float32
    for i, p in enumerate(paths):
        ref = (wavfile.read(str(p))[1] / 32768.0).astype(np.float32)[offsets[i]:offsets[i] + 4000]
        np.testing.assert_array_equal(out[i, :len(ref)], ref)
        assert (out[i, len(ref):] == 0).all()
    assert wavio.read_batch([], [], 10).shape == (0, 10)


def test_write_pcm16_and_float(tmp_path, tone):
    for as_float in (False, True):
        mine, theirs = tmp_path / f"p{as_float}.wav", tmp_path / f"j{as_float}.wav"
        wavio.wav_write(mine, tone, 16000, as_float=as_float)
        jwavio.wav_write(theirs, tone, 16000, as_float=as_float)
        assert mine.read_bytes() == theirs.read_bytes()
        sr, y = wavfile.read(str(mine))
        assert sr == 16000
        if as_float:
            np.testing.assert_array_equal(y, tone)
        else:
            assert y.dtype == np.int16
            np.testing.assert_allclose(y / 32767.0, tone, atol=1 / 32767.0)


def test_save_wav_writes_through_the_reader(tmp_path, tone):
    from spiking_fullsubnet_tpu.dsp import io as jio

    from spiking_fullsubnet_torch.dsp import io as pio

    loud = np.concatenate([tone, [1.5, -2.0]]).astype(np.float32)
    pio.save_wav(loud, tmp_path / "p.wav", 16000)
    jio.save_wav(loud, tmp_path / "j.wav", 16000)
    assert (tmp_path / "p.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()


def test_error_codes(tmp_path):
    with pytest.raises(IOError, match="cannot open"):
        wavio.wav_read(tmp_path / "missing.wav")
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    with pytest.raises(IOError, match="unsupported|malformed"):
        wavio.wav_read(bad)
    with pytest.raises(IOError, match="batch read failed"):
        wavio.read_batch([bad], [0], 10)
    assert wavio.ERRORS == jwavio._ERRORS


# ------------------------------------------------------------------ the DNS dataset


@pytest.fixture()
def dns_root(tmp_path):
    sr = 16000
    (tmp_path / "noisy").mkdir()
    (tmp_path / "clean").mkdir()
    rng = np.random.default_rng(5)
    # one file shorter than 30 s (zero pad), one longer (truncation)
    for fid, secs in [(1, 8.0), (2, 33.0)]:
        t = int(secs * sr)
        clean = (rng.standard_normal(t) * 0.1).astype(np.float32)
        noisy = clean + (rng.standard_normal(t) * 0.05).astype(np.float32)
        wavfile.write(str(tmp_path / "noisy" / f"book_snr10_tl-25_fileid_{fid}.wav"), sr,
                      (noisy * 32767).astype(np.int16))
        wavfile.write(str(tmp_path / "clean" / f"clean_fileid_{fid}.wav"), sr,
                      (clean * 32767).astype(np.int16))
    return tmp_path


@pytest.mark.parametrize("train", [True, False])
def test_dns_crop_window_path(dns_root, train):
    from spiking_fullsubnet_tpu.data.dns_audio import DNSAudio as JDNSAudio

    from spiking_fullsubnet_torch.data.dns_audio import DNSAudio

    fast = DNSAudio(root=str(dns_root), train=train, sublen=6)
    slow = DNSAudio(root=str(dns_root), train=train, sublen=6)
    slow.use_native = False
    jax_ds = JDNSAudio(root=str(dns_root), train=train, sublen=6)
    assert fast.use_native
    for n in range(len(fast)):
        items = []
        for ds in (fast, slow, jax_ds):
            np.random.seed(1234 + n)
            items.append(ds[n])
        (nf, cf, pf), (ns, cs, ps), (nj, cj, pj) = items
        assert pf == ps == pj
        assert nf.shape == ((96000,) if train else (480000,)) and nf.dtype == np.float32
        for a, b in ((nf, ns), (cf, cs), (nf, nj), (cf, cj)):
            np.testing.assert_array_equal(a, b)
