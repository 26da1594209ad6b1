"""The port's input pipeline against spiking_fullsubnet_tpu.data and its
WAV IO, all exact: SyntheticNoisyDataset items, the DataLoader's batches
and shuffle order over three epochs, DNSAudio on WAVs written here (as
tests/test_dns_audio_native.py writes them), and the port's scipy reader
against the JAX package's scipy path and its native reader."""

from __future__ import annotations

import numpy as np
import pytest
from scipy.io import wavfile

from spiking_fullsubnet_tpu.data import DataLoader as JaxLoader
from spiking_fullsubnet_tpu.data import DNSAudio as JaxDNSAudio
from spiking_fullsubnet_tpu.data import SyntheticNoisyDataset as JaxSynthetic
from spiking_fullsubnet_tpu.dsp import io as jio
from spiking_fullsubnet_tpu.dsp import norms as jnorms
from spiking_fullsubnet_tpu.native import wavio

from spiking_fullsubnet_torch.data import DataLoader, DNSAudio, SyntheticNoisyDataset
from spiking_fullsubnet_torch.dsp import io as pio
from spiking_fullsubnet_torch.dsp import norms as pnorms


def _equal_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("kw", [dict(), dict(num_samples=5, duration=0.7, snr_db=-3.0, seed=77),
                                dict(num_samples=3, duration=0.3, sr=8000, train=False, seed=9)])
def test_synthetic_items_match_jax(kw):
    ds, ref = SyntheticNoisyDataset(**kw), JaxSynthetic(**kw)
    assert len(ds) == len(ref)
    for i in range(len(ds)):
        _equal_items(ds[i], ref[i])


@pytest.mark.parametrize("shuffle,drop_last,batch_size,workers",
                         [(True, True, 4, 0), (True, False, 3, 0), (False, False, 4, 0),
                          (True, True, 2, 2)])
def test_loader_batches_and_shuffle_match_jax_over_epochs(shuffle, drop_last, batch_size, workers):
    kw = dict(batch_size=batch_size, shuffle=shuffle, drop_last=drop_last, num_workers=workers,
              seed=3407, pin_memory=True)
    loader = DataLoader(SyntheticNoisyDataset(num_samples=10, duration=0.05), **kw)
    ref = JaxLoader(JaxSynthetic(num_samples=10, duration=0.05), **kw)
    assert len(loader) == len(ref) == (10 // batch_size if drop_last else -(-10 // batch_size))
    orders = []
    for epoch in range(3):
        loader.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert loader._indices() == ref._indices()
        orders.append(loader._indices())
        got, want = list(loader), list(ref)
        assert len(got) == len(want) == len(loader)
        for b, r in zip(got, want):
            _equal_items(b, r)
    assert (orders[0] != orders[1]) == shuffle


def test_loader_surfaces_worker_errors_and_stops_early():
    class Bad(SyntheticNoisyDataset):
        def __getitem__(self, i):
            if i == 5:
                raise KeyError("bad item")
            return super().__getitem__(i)

    with pytest.raises(KeyError, match="bad item"):
        list(DataLoader(Bad(num_samples=8, duration=0.01), batch_size=2, num_workers=2))
    it = iter(DataLoader(SyntheticNoisyDataset(num_samples=40, duration=0.01), batch_size=1,
                         num_workers=2, prefetch=1))
    next(it)
    it.close()  # the worker thread is joined, not left blocked on a full queue


@pytest.fixture()
def dns_root(tmp_path):
    sr = 16000
    (tmp_path / "noisy").mkdir()
    (tmp_path / "clean").mkdir()
    rng = np.random.default_rng(5)
    # one file shorter than 30 s (zero-pad branch), one longer (truncate branch)
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
def test_dns_audio_matches_jax(dns_root, train):
    ds = DNSAudio(root=str(dns_root), train=train, sublen=6)
    refs = {}
    for native in (True, False):
        refs[native] = JaxDNSAudio(root=str(dns_root), train=train, sublen=6)
        refs[native].use_native = native and wavio.native_available()
    assert len(ds) == 2
    assert ds._get_filenames(0) == refs[False]._get_filenames(0)
    for n in range(len(ds)):
        np.random.seed(1234 + n)
        got = ds[n]
        assert got[0].shape == ((96000,) if train else (480000,))
        assert got[0].dtype == np.float32
        for ref in refs.values():
            np.random.seed(1234 + n)
            _equal_items(got, ref[n])


def test_wav_io_matches_jax_scipy_path_and_native_reader(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    y = np.clip(rng.standard_normal(12345) * 0.3, -1.2, 1.2)
    pio.save_wav(y, tmp_path / "port.wav", 16000)
    with monkeypatch.context() as m:  # the JAX package's scipy writer
        m.setattr(jio._native, "native_available", lambda: False)
        jio.save_wav(y, tmp_path / "jax.wav", 16000)
        ref = jio.load_wav(tmp_path / "jax.wav")
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    got = pio.load_wav(tmp_path / "port.wav")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    if wavio.native_available():  # the native reader gives the scipy path's values
        np.testing.assert_array_equal(got, wavio.wav_read(tmp_path / "port.wav")[0])
    np.testing.assert_array_equal(pio.load_wav(tmp_path / "port.wav", sr=8000),
                                  jio.load_wav(tmp_path / "port.wav", sr=8000))
    a, sra = pio.load_audio(tmp_path / "port.wav", duration=0.5, rng=np.random.default_rng(1))
    b, srb = jio.load_audio(tmp_path / "port.wav", duration=0.5, rng=np.random.default_rng(1))
    assert sra == srb == 16000
    np.testing.assert_array_equal(a, b)
    a, _ = pio.load_audio(tmp_path / "port.wav", duration=1.0, sr=8000)
    b, _ = jio.load_audio(tmp_path / "port.wav", duration=1.0, sr=8000)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pio.subsample(got, 4000, start_idx=100),
                                  jio.subsample(got, 4000, start_idx=100))
    np.testing.assert_array_equal(pio.subsample(got, 4000, rng=np.random.default_rng(2)),
                                  jio.subsample(got, 4000, rng=np.random.default_rng(2)))
    np.testing.assert_array_equal(pio.subsample(got[:100], 400), jio.subsample(got[:100], 400))
    (tmp_path / "d").mkdir()
    for name in ("b.wav", "a.WAV", "c.txt"):
        (tmp_path / "d" / name).write_bytes(b"")
    (tmp_path / "list.scp").write_text(f"{tmp_path / 'port.wav'}\n")
    for arg in (tmp_path / "d", [tmp_path / "d", tmp_path / "list.scp"], tmp_path / "port.wav"):
        assert pio.find_files(arg) == jio.find_files(arg)
    assert pio.find_files(tmp_path / "d", offset=1, limit=1) == jio.find_files(tmp_path / "d",
                                                                              offset=1, limit=1)


def test_norms_match_jax():
    rng = np.random.default_rng(4)
    y = rng.standard_normal(16000) * 0.1
    noise = rng.standard_normal(16000) * 0.05
    assert pnorms.compute_rms(y) == jnorms.compute_rms(y)
    for name, args in [("norm_amplitude", (y,)), ("loudness_max_norm", (y,)),
                       ("loudness_rms_norm", (y,)), ("tune_dB_FS", (y,))]:
        for a, b in zip(getattr(pnorms, name)(*args), getattr(jnorms, name)(*args)):
            np.testing.assert_array_equal(a, b)
    assert pnorms.active_rms(y, noise) == jnorms.active_rms(y, noise)
    assert pnorms.sxr2gain(y, noise, 5.0) == jnorms.sxr2gain(y, noise, 5.0)
    assert pnorms.activity_detector(y) == jnorms.activity_detector(y)
    assert pnorms.is_clipped(y * 20) and not pnorms.is_clipped(y)
