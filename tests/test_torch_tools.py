"""The port's tools (``spiking_fullsubnet_torch/tools/``) against the JAX
package's root ``tools/*.py``, each loaded by path and run on the same
inputs: the files each writes (CSV, WAV, ``.npy``, HDF5, text, JSON,
markdown and YAML) equal, float cells at 1e-6 and everything else exactly;
the N-DNS board and the model zoo end to end on trees the tests write
(params exact, SI-SNR within 1e-3 dB, both packages in float64 where the
weights are). Every tool wants the card unless given ``--device cpu``, and
none imports JAX, the JAX package or a root tool."""

from __future__ import annotations

import ast
import csv
import importlib
import importlib.util
import json
import sys
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from spiking_fullsubnet_tpu.models import spiking_fullsubnet as JSF

from spiking_fullsubnet_torch.dsp.io import save_wav
from spiking_fullsubnet_torch.models import spiking_fullsubnet as PSF
from spiking_fullsubnet_torch.runtime.config import toml_dump
from spiking_fullsubnet_torch.runtime.convert import load_npz, reference_state_dict
from spiking_fullsubnet_torch.tools import (build_model_zoo, calculate_metrics, check_audio,
                                            dns_mos, extract_speaker_embedding, loudness_norm,
                                            metricsboard_writeout, misc_data, noise_to_hdf5,
                                            reproduce_board, resampling,
                                            validate_metric_backends)

ROOT = Path(__file__).resolve().parent.parent
TOOLS = ROOT / "spiking_fullsubnet_torch" / "tools"
ZOO = ROOT / "model_zoo" / "intel_ndns" / "spike_fsb"
FREEZE = ROOT / "recipes" / "intel_ndns" / "spiking_fullsubnet_freeze_phase"
CPU = ["--device", "cpu"]


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["tool"] + [str(a) for a in argv])
    return mod.main()


def port_argv(argv):
    return [str(a) for a in argv] + CPU


def tone(freq, seconds, amp=0.3, seed=0, noise=0.05, sr=16000):
    t = np.arange(int(sr * seconds)) / sr
    rng = np.random.default_rng(seed)
    return (amp * np.sin(2 * np.pi * freq * t)
            + noise * rng.standard_normal(t.size)).astype(np.float32)


def put(y, path):
    path.parent.mkdir(parents=True, exist_ok=True)
    save_wav(y, path, 16000)


@pytest.fixture()
def wav_tree(tmp_path):
    """est/ and ref/ of four utterances (one in a subdirectory), a silent
    and a clipped file among the estimates."""
    root = tmp_path / "wavs"
    for i, (sub, f) in enumerate([("", 220.0), ("", 330.0), ("sub", 440.0), ("", 550.0)]):
        ref = tone(f, 0.75, noise=0.0, seed=i)
        est = tone(f, 0.75 + 0.01 * i, seed=10 + i)
        if i == 1:
            est = np.clip(est * 6.0, -1.0, 1.0)
        if i == 3:
            est = np.zeros_like(est)
        put(ref, root / "ref" / sub / f"u{i}.wav")
        put(est, root / "est" / sub / f"u{i}.wav")
    return root


def read_csv(path):
    with open(path, newline="") as f:
        r = csv.reader(f)
        return next(r), list(r)


def assert_csv_equal(got_path, want_path):
    got_cols, got = read_csv(got_path)
    want_cols, want = read_csv(want_path)
    assert got_cols == want_cols and len(got) == len(want)
    for g_row, w_row in zip(got, want):
        for c, g, w in zip(want_cols, g_row, w_row):
            try:
                np.testing.assert_allclose(float(g), float(w), rtol=0, atol=1e-6, err_msg=c)
            except ValueError:
                assert g == w, c


def assert_wavs_equal(got_dir, want_dir):
    got = sorted(p.relative_to(got_dir) for p in got_dir.rglob("*.wav"))
    assert got and got == sorted(p.relative_to(want_dir) for p in want_dir.rglob("*.wav"))
    for rel in got:
        (sr_g, g), (sr_w, w) = wavfile.read(got_dir / rel), wavfile.read(want_dir / rel)
        assert sr_g == sr_w and g.dtype == w.dtype and np.array_equal(g, w), rel


# ------------------------------------------------------------------ the metric CLIs


@pytest.mark.parametrize("workers", [1, 2])
def test_calculate_metrics_csv_equals_jax(wav_tree, tmp_path, monkeypatch, capsys, workers):
    # (pesq_wb would import the test suite's stand-in `pesq` wherever the
    # reference oracle's stubs are installed; its metric has tests of its own)
    argv = ["-E", wav_tree / "est", "-R", wav_tree / "ref", "-M", "si_sdr", "stoi"]
    run_jax(jax_tool("calculate_metrics"), argv + ["-O", tmp_path / "jax.csv",
                                                   "--num_workers", 1], monkeypatch)
    capsys.readouterr()
    means = calculate_metrics.main(port_argv(argv + ["-O", tmp_path / "port.csv",
                                                     "--num_workers", workers]))
    assert_csv_equal(tmp_path / "port.csv", tmp_path / "jax.csv")
    assert set(means) == {"si_sdr", "stoi"}
    out = capsys.readouterr().out
    assert "| si_sdr | stoi |" in out and "Wrote 4 rows" in out


class StubMOS:
    """DNSMOS's interface without onnxruntime: scores from the audio."""

    def __init__(self, input_sr=16000, device=-1, model_dir=None):
        self.input_sr = input_sr

    def __call__(self, y, return_p808=True):
        row = {"OVRL": 3.0 + float(np.mean(np.abs(y))), "SIG": 3.3, "BAK": float(len(y))}
        if return_p808:
            row["P808_MOS"] = 3.5 + float(np.std(y))
        return row


@pytest.mark.parametrize("p808", [True, False])
def test_dns_mos_csv_equals_jax(wav_tree, tmp_path, monkeypatch, p808):
    jmod = jax_tool("dns_mos")
    monkeypatch.setattr(jmod, "DNSMOS", StubMOS)
    monkeypatch.setattr(dns_mos, "DNSMOS", StubMOS)
    extra = [] if p808 else ["--no_p808"]
    run_jax(jmod, ["-D", wav_tree / "est", "-O", tmp_path / "jax.csv"] + extra, monkeypatch)
    dns_mos.main(port_argv(["-D", wav_tree / "est", "-O", tmp_path / "port.csv"] + extra))
    assert_csv_equal(tmp_path / "port.csv", tmp_path / "jax.csv")


def test_validate_metric_backends_json_equals_jax(tmp_path, monkeypatch):
    jmod = jax_tool("validate_metric_backends")
    monkeypatch.setattr(jmod, "FIXTURE", tmp_path / "jax.json")
    jmod.main()
    got = validate_metric_backends.main(port_argv(["--output", tmp_path / "port.json"]))
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text()) == got
    pairs, jpairs = validate_metric_backends.fixture_signals(), jmod.fixture_signals()
    assert all(np.array_equal(a, b) for p, q in zip(pairs, jpairs) for a, b in zip(p, q))


# ------------------------------------------------------------------ the data CLIs


@pytest.mark.parametrize("cmd", ["clip_activity", "existence", "missing_pair", "mono",
                                 "non_signal"])
def test_check_audio_prints_what_jax_prints(wav_tree, tmp_path, monkeypatch, capsys, cmd):
    scp = tmp_path / "list.scp"
    scp.write_text(f"u0 {wav_tree / 'est' / 'u0.wav'}\nu9 {wav_tree / 'est' / 'gone.wav'}\n")
    args = {"clip_activity": [cmd, wav_tree / "est", "--min_activity", 0.3],
            "existence": [cmd, scp],
            "missing_pair": [cmd, wav_tree / "est", wav_tree / "est" / "sub"],
            "mono": [cmd, wav_tree / "est"],
            "non_signal": [cmd, wav_tree / "est"]}[cmd]
    run_jax(jax_tool("check_audio"), args, monkeypatch)
    want = capsys.readouterr().out
    check_audio.main(CPU + [str(a) for a in args])
    got = capsys.readouterr().out
    assert got == want and (got.strip() or cmd == "mono")


def test_loudness_norm_wavs_equal_jax(wav_tree, tmp_path, monkeypatch):
    args = ["-I", wav_tree / "ref", "--lvl", -23]
    run_jax(jax_tool("loudness_norm"), args + ["-O", tmp_path / "jax"], monkeypatch)
    loudness_norm.main(port_argv(args + ["-O", tmp_path / "port"]))
    assert_wavs_equal(tmp_path / "port", tmp_path / "jax")


def test_resampling_wavs_equal_jax(wav_tree, tmp_path, monkeypatch):
    args = ["-I", wav_tree / "est", "--sr", 8000, "--num_workers", 1]
    run_jax(jax_tool("resampling"), args + ["-O", tmp_path / "jax"], monkeypatch)
    resampling.main(port_argv(args + ["-O", tmp_path / "port"]))
    assert_wavs_equal(tmp_path / "port", tmp_path / "jax")


@pytest.mark.parametrize("cmd", ["split_scp", "dirs2txt", "txt2duration", "select_subset",
                                 "trim_seg", "seek_best_score"])
def test_misc_data_outputs_equal_jax(wav_tree, tmp_path, monkeypatch, capsys, cmd):
    outs = {}
    for who in ("jax", "port"):
        d = tmp_path / who
        d.mkdir()
        scp = d / "list.scp"
        scp.write_text("".join(f"u{i} {p}\n" for i, p in enumerate(
            sorted((wav_tree / "est").rglob("*.wav")))))
        log = d / "train.log"
        log.write_text("epoch 1\nFound new best score: 0.5\nx\nFound new best score: 1.25\n")
        args = {"split_scp": [cmd, scp, "--num_splits", 3],
                "dirs2txt": [cmd, wav_tree / "est", "-O", d / "files.txt"],
                "txt2duration": [cmd, scp],
                "select_subset": [cmd, wav_tree / "est", "--num", 2, "--seed", 4,
                                  "-O", d / "subset.txt"],
                "trim_seg": [cmd, wav_tree / "est", "--seconds", 0.3, "-O", d / "trim"],
                "seek_best_score": [cmd, log]}[cmd]
        if who == "jax":
            run_jax(jax_tool("misc_data"), args, monkeypatch)
        else:
            misc_data.main(CPU + [str(a) for a in args])
        printed = capsys.readouterr().out.replace(str(d), "<dir>")
        files = {p.relative_to(d).as_posix(): p.read_bytes() for p in sorted(d.rglob("*"))
                 if p.is_file()}
        outs[who] = (printed, files)
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][1]) > 2 or outs["port"][0]


def test_noise_to_hdf5_equals_jax(wav_tree, tmp_path, monkeypatch):
    h5py = pytest.importorskip("h5py")
    for dtype in ("float16", "float32"):
        args = [wav_tree / "est", "--sr", 8000, "--dtype", dtype]
        run_jax(jax_tool("noise_to_hdf5"), args[:1] + [tmp_path / "jax.h5"] + args[1:],
                monkeypatch)
        noise_to_hdf5.main(port_argv(args[:1] + [tmp_path / "port.h5"] + args[1:]))
        with h5py.File(tmp_path / "port.h5") as got, h5py.File(tmp_path / "jax.h5") as want:
            assert dict(got.attrs) == dict(want.attrs) and sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k][()], want[k][()])


def test_extract_speaker_embedding_logmel_equals_jax(wav_tree, tmp_path, monkeypatch):
    args = ["-s", wav_tree / "est", "--backend", "logmel"]
    run_jax(jax_tool("extract_speaker_embedding"), args + ["-o", tmp_path / "jax"], monkeypatch)
    extract_speaker_embedding.main(port_argv(args + ["-o", tmp_path / "port"]))
    got = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.npy"))
    assert len(got) == 4
    for rel in got:
        g, w = np.load(tmp_path / "port" / rel), np.load(tmp_path / "jax" / rel)
        assert g.shape == w.shape == (128,) and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    if importlib.util.find_spec("speechbrain") is None:
        with pytest.raises(SystemExit, match="speechbrain is not installed"):
            extract_speaker_embedding.main(port_argv(["-s", wav_tree / "est", "-o", tmp_path / "e",
                                                      "--backend", "ecapa"]))


def test_metricsboard_writeout_equals_jax(tmp_path, monkeypatch):
    entries = [{"team": "t", "model": "a", "SI-SNR": 13.5, "params": 10},
               {"team": "t", "model": "b", "SI-SNR": 14.25, "MOS_ovrl": 3.1},
               {"team": "t", "model": "c", "SI-SNR": None}]
    src = tmp_path / "entries.json"
    src.write_text(json.dumps(entries))
    for sub in ([], ["--subtract_noisy_mos"]):
        run_jax(jax_tool("metricsboard_writeout"), ["-I", src, "-O", tmp_path / "jax"] + sub,
                monkeypatch)
        metricsboard_writeout.main([str(a) for a in ["-I", src, "-O", tmp_path / "port"] + sub])
        for ext in (".md", ".yml"):
            assert (tmp_path / f"port{ext}").read_text() == (tmp_path / f"jax{ext}").read_text()


# ------------------------------------------------------------------ the N-DNS board


@pytest.fixture()
def dns_tree(tmp_path):
    """tests/test_reproduce_board.py's five-utterance DNSAudio tree."""
    rng = np.random.default_rng(7)
    root = tmp_path / "ndns_val"
    for fid in range(5):
        t = np.arange(16000 * 2) / 16000
        clean = 0.3 * np.sin(2 * np.pi * (180 + 40 * fid) * t).astype(np.float32)
        noisy = clean + 0.08 * rng.standard_normal(len(clean)).astype(np.float32)
        put(noisy, root / "noisy" / f"book_snr10_tl-25_fileid_{fid}.wav")
        put(clean, root / "clean" / f"clean_fileid_{fid}.wav")
    return root


# tests/test_reproduce_board.py:63-66's tiny model
TINY = dict(fb_hidden_size=16, sb_hidden_size=8, fb_num_layers=1, sb_num_layers=1,
            df_orders=[2, 1, 1], scan_mode="fused")


def test_reproduce_board_gate_returns_2(tmp_path, capsys):
    assert reproduce_board.main(["--dns_root", str(tmp_path / "nope"), "--out",
                                 str(tmp_path / "o")]) == 2
    assert "skipping cleanly" in capsys.readouterr().err


def test_reproduce_board_row_equals_jax(dns_tree, tmp_path, monkeypatch, capsys):
    jmod = jax_tool("reproduce_board")
    recipe = reproduce_board.RECIPE / "baseline_m.toml"
    margs = tomllib.loads(recipe.read_text())["model"]["args"] | TINY
    cfg = PSF.SpikingFullSubNetConfig(**PSF._norm_cfg_args(margs))
    params, state = PSF.spiking_fullsubnet_init(3, cfg, device="cpu")
    ckpt = tmp_path / "pytorch_model.bin"
    torch.save(reference_state_dict(params, state, generation="latest"), ckpt)

    def tiny(build, dump, load):
        def build_config(size, dns_root, out_dir, limit=None):
            path = build(size, dns_root, out_dir, limit=limit)
            c = load(path)
            c["model"]["args"].update(TINY)
            dump(c, path)
            return path
        return build_config

    def load_toml(path):
        return tomllib.loads(Path(path).read_text())

    monkeypatch.setattr(jmod, "build_config", tiny(jmod.build_config, jmod._dump_toml, load_toml))
    monkeypatch.setattr(reproduce_board, "build_config",
                        tiny(reproduce_board.build_config, toml_dump, load_toml))
    rows = {}
    for who, main in (("jax", jmod.main), ("port", reproduce_board.main)):
        argv = ["--dns_root", str(dns_tree), "--size", "m", "--out", str(tmp_path / who),
                "--entry_name", "tiny", "--torch_ckpt", str(ckpt)]
        assert main(argv + (CPU if who == "port" else [])) == 0
        rows[who] = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                                if ln.startswith("{")][-1])
    got, want = rows["port"], rows["jax"]
    assert got.keys() == want.keys() and got["team"] == "spiking_fullsubnet_torch"
    assert got["params"] == want["params"] == sum(t.numel() for t in _leaves(params))
    assert abs(got["SI-SNR"] - want["SI-SNR"]) < 1e-3 and np.isfinite(got["SI-SNR"])
    for k in want:
        if k not in ("team", "SI-SNR", "SI-SNRi_data", "SI-SNRi_enc+dec"):
            assert got[k] == want[k], k
    assert got["latency_total_ms"] == pytest.approx(8.036)
    for ext in ("md", "yml"):
        assert "tiny" in (tmp_path / "port" / f"metricsboard_validation.{ext}").read_text()


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


# ------------------------------------------------------------------ the model zoo


def write_reference_zoo(root: Path, size: str, dtype=torch.float64) -> Path:
    """A tree of the reference zoo's layout for ``baseline_<size>``: the
    freeze-phase recipe's [model.args] as the shipped ``[model_g.args]``, and
    the in-repo weights in the reference's names as the generator."""
    d = root / f"baseline_{size}"
    (d / "checkpoints" / "best").mkdir(parents=True)
    args = tomllib.loads((FREEZE / f"baseline_{size}.toml").read_text())["model"]["args"]
    toml_dump({"model_g": {"args": args}}, d / f"config__baseline_{size}.toml")
    tree = load_npz(str(ZOO / f"baseline_{size}.npz"), device="cpu")
    sd = reference_state_dict(tree["params"], tree["state"])
    torch.save({k: v.to(dtype) for k, v in sd.items()}, d / "checkpoints" / "best" /
               "pytorch_model.bin")
    return root


def test_build_model_zoo_entries_equal_jax(tmp_path, monkeypatch):
    ref = write_reference_zoo(tmp_path / "ref", "s")
    jmod = jax_tool("build_model_zoo")
    # both in float64: the JAX tool takes its weights' type from its init's
    # template (float32) and its audio's from the fixture
    init = JSF.spiking_fullsubnet_init
    monkeypatch.setattr(JSF, "spiking_fullsubnet_init", lambda key, cfg: jax.tree.map(
        lambda a: a.astype(jnp.float64), init(key, cfg)))
    scores = {"jax": [], "port": []}
    for who, mod in (("jax", jmod), ("port", build_model_zoo)):
        real, fixture = mod.si_sdr, mod.speechlike_fixture
        monkeypatch.setattr(mod, "si_sdr", lambda e, r, real=real, who=who: scores[who].append(
            real(e, r)) or scores[who][-1])
        monkeypatch.setattr(mod, "speechlike_fixture", lambda n, fixture=fixture: (
            (c.astype(np.float64), x.astype(np.float64)) for c, x in fixture(n)))
    argv = ["--sizes", "s", "alif", "--utts", "2", "--ref-zoo", str(ref)]
    jmod.main(argv + ["--out", str(tmp_path / "jax")])
    build_model_zoo.main(argv + ["--out", str(tmp_path / "port")] + CPU)
    got = json.loads((tmp_path / "port" / "entries_framework.json").read_text())
    want = json.loads((tmp_path / "jax" / "entries_framework.json").read_text())
    assert len(got) == len(want) == 2 and got[0]["params"] == want[0]["params"] == 520_920
    np.testing.assert_allclose(scores["port"], scores["jax"], rtol=0, atol=1e-3)
    assert min(scores["port"]) > 8.0  # real enhancement on the shipped config
    for g, w in zip(got, want):
        for k in w:
            if k in ("team", "date", "model_path", "SI-SNR"):
                continue
            assert g[k] == w[k], k
        assert g["team"] == "spiking_fullsubnet_torch"
    assert abs(got[0]["SI-SNR"] - want[0]["SI-SNR"]) <= 0.01  # both rounded to 0.01 dB
    assert (tmp_path / "port" / "intel_ndns" / "spike_fsb" / "baseline_s.npz").exists()
    md = (tmp_path / "port" / "metricsboard_framework.md").read_text()
    assert "baseline_s" in md and "ALIF" in md and "SI-SNRi_data" in md


def test_build_model_zoo_says_no_tree_was_given(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("SFSN_REF_ZOO", raising=False)
    with pytest.raises(SystemExit):
        build_model_zoo.main(["--out", str(tmp_path)] + CPU)
    assert "no reference zoo was given" in capsys.readouterr().err


# ------------------------------------------------------------------ every tool's policy

NEW_TOOLS = ["bench_gsu_kernel", "profile_trace", "reproduce_board", "build_model_zoo",
             "calculate_metrics", "dns_mos", "check_audio", "loudness_norm", "resampling",
             "misc_data", "noise_to_hdf5", "extract_speaker_embedding",
             "validate_metric_backends"]
NEW_FILES = [f"spiking_fullsubnet_torch/tools/{t}.py" for t in NEW_TOOLS] + [
    "spiking_fullsubnet_torch/tools/_common.py",
    "spiking_fullsubnet_torch/tools/metricsboard_writeout.py",
    "spiking_fullsubnet_torch/runtime/timing.py", "spiking_fullsubnet_torch/runtime/roofline.py",
    "spiking_fullsubnet_torch/runtime/cache.py"]


@pytest.mark.parametrize("path", NEW_FILES)
def test_new_modules_import_neither_jax_nor_the_jax_package_nor_a_root_tool(path):
    tree = ast.parse((ROOT / path).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    top = {n.split(".")[0] for n in names}
    assert not top & {"jax", "jaxlib", "spiking_fullsubnet_tpu", "pandas", "tools",
                      "metricsboard_writeout"}, (path, top)
    assert "sys.path" not in (ROOT / path).read_text()


def _policy_argv(tool, tmp_path):
    wav = tmp_path / "w"
    put(tone(200.0, 0.1), wav / "noisy" / "a.wav")
    return {"bench_gsu_kernel": ["--batch", "1", "--time", "2", "--hidden", "4", "--input", "3"],
            "profile_trace": ["--seconds", "0.05", "--batch", "1"],
            "reproduce_board": ["--dns_root", wav, "--out", tmp_path / "o",
                                "--ckpt_path", "init"],
            "build_model_zoo": ["--ref-zoo", tmp_path / "z", "--out", tmp_path / "o"],
            "calculate_metrics": ["-E", wav, "-R", wav, "-O", tmp_path / "m.csv"],
            "dns_mos": ["-D", wav],
            "check_audio": ["mono", wav],
            "loudness_norm": ["-I", wav, "-O", tmp_path / "o"],
            "resampling": ["-I", wav, "-O", tmp_path / "o", "--sr", 8000],
            "misc_data": ["dirs2txt", wav, "-O", tmp_path / "f.txt"],
            "noise_to_hdf5": [wav, tmp_path / "n.h5"],
            "extract_speaker_embedding": ["-s", wav, "-o", tmp_path / "e"],
            "validate_metric_backends": ["--output", tmp_path / "g.json"]}[tool]


@pytest.mark.parametrize("tool", NEW_TOOLS)
def test_every_tool_wants_cuda_unless_asked_for_the_cpu(tool, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would run on it")
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"spiking_fullsubnet_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        mod.main([str(a) for a in _policy_argv(tool, tmp_path)])
    assert not (tmp_path / "o").exists() and not (tmp_path / "g.json").exists()
