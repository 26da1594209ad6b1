"""The port's bench support against the JAX package's: the roofline's
analytic cost and report, the timer's checksum and chain differencing, and
where the kernel build cache lives; the kernel bench and the profiler trace
run on the CPU at a tiny size, the bench's scan against JAX's."""

from __future__ import annotations

import json
import tomllib
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from spiking_fullsubnet_tpu.models import spiking_fullsubnet as JSF
from spiking_fullsubnet_tpu.ops.gsu import gsu_stack_apply as jax_gsu_stack_apply
from spiking_fullsubnet_tpu.runtime import roofline as JRL
from spiking_fullsubnet_tpu.runtime import timing as JT

from spiking_fullsubnet_torch.models import spiking_fullsubnet as PSF
from spiking_fullsubnet_torch.ops import gsu_kernels as gk
from spiking_fullsubnet_torch.runtime import cache, roofline, timing
from spiking_fullsubnet_torch.tools import bench_gsu_kernel, profile_trace

ROOT = Path(__file__).resolve().parent.parent
RECIPES = ROOT / "recipes" / "intel_ndns"


def _model_args(toml):
    return tomllib.loads(toml.read_text())["model"]["args"]


def _configs(name):
    """(JAX config, port config) of a named configuration."""
    if name == "flagship M":  # baseline_m.toml's [model.args], the presets' flagship
        args = {k: v for k, v in _model_args(RECIPES / "spiking_fullsubnet" /
                                              "baseline_m.toml").items() if k != "scan_mode"}
        return (JSF.SpikingFullSubNetConfig(**JSF._norm_cfg_args(args)),
                PSF.SpikingFullSubNetConfig(**PSF._norm_cfg_args(args)))
    if name.startswith("zoo"):  # the zoo checkpoints' frozen Separator configs
        args = _model_args(RECIPES / "spiking_fullsubnet_freeze_phase" /
                           f"baseline_{name[-1].lower()}.toml")
        return (JSF.separator_config(**JSF._norm_cfg_args(args)),
                PSF.separator_config(**PSF._norm_cfg_args(args)))
    kw = dict(fb_hidden_size=16, sb_hidden_size=8, fb_num_layers=1, sb_num_layers=1,
              df_orders=(2, 1, 1), hop_length=64, shared_weights=False)
    return JSF.SpikingFullSubNetConfig(**kw), PSF.SpikingFullSubNetConfig(**kw)


CONFIGS = ["flagship M", "zoo S", "zoo M", "tiny"]


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_cost_equals_jax(name, dtype_bytes):
    jcfg, pcfg = _configs(name)
    want = JRL.spiking_fullsubnet_cost(jcfg, 16000, dtype_bytes)
    got = roofline.spiking_fullsubnet_cost(pcfg, 16000, dtype_bytes)
    assert (got.flops_per_frame_per_item, got.bytes_per_frame_per_item,
            got.frames_per_audio_second) == (want.flops_per_frame_per_item,
                                             want.bytes_per_frame_per_item,
                                             want.frames_per_audio_second)
    assert got.flops_per_audio_second() == want.flops_per_audio_second()
    assert got.bytes_per_audio_second() == want.bytes_per_audio_second()
    for args in [(320, 320, 2, True, 64), (224, 224, 2, False, 30), (7, 5, 3, True, 1)]:
        assert roofline._gsu_stack_macs(*args) == JRL._gsu_stack_macs(*args)


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("matmul_dtype", ["bf16", "f32"])
def test_roofline_report_equals_jax_on_the_same_specs(name, matmul_dtype, monkeypatch):
    jcfg, pcfg = _configs(name)
    monkeypatch.setitem(JRL.CHIP_SPECS, "h100_sxm", dict(roofline.CHIP_SPECS["h100_sxm"]))
    for rate in (1.0, 26627.0, 3.5e5):
        want = JRL.roofline_report(jcfg, rate, chip="h100_sxm", matmul_dtype=matmul_dtype)
        got = roofline.roofline_report(pcfg, rate, matmul_dtype=matmul_dtype)
        assert got == want


def test_chip_specs_are_the_h100s_only():
    assert roofline.CHIP_SPECS == {"h100_sxm": {"bf16": 989e12, "f32": 67e12,
                                                "hbm_gbps": 3.35e12}}


def _tree(rng):
    return {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": [rng.standard_normal(7), rng.integers(-9, 9, (4,)).astype(np.int32)],
            "c": (rng.standard_normal((2, 2)).astype(np.float32) > 0)}


def test_checksum_equals_jax():
    tree = _tree(np.random.default_rng(5))
    as_jax = {"a": jnp.asarray(tree["a"]), "b": [jnp.asarray(x) for x in tree["b"]],
              "c": jnp.asarray(tree["c"])}
    as_torch = {"a": torch.from_numpy(tree["a"]), "b": [torch.from_numpy(x) for x in tree["b"]],
                "c": torch.from_numpy(tree["c"])}
    want = float(JT.checksum(as_jax))
    got = timing.checksum(as_torch)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(timing.fetch(got), want, rtol=1e-6)
    assert timing.fetch(timing.checksum({})) == 0.0


class FakeClock:
    """A host clock that advances only when the timed function runs
    (``per_call`` seconds a call) and when it is read (``per_read``)."""

    def __init__(self, per_call, per_read):
        self.now, self.per_call, self.per_read, self.calls = 0.0, per_call, per_read, 0

    def perf_counter(self):
        self.now += self.per_read
        return self.now

    def fn(self, x):
        self.calls += 1
        self.now += self.per_call
        return x * 2.0


@pytest.mark.parametrize("iters,reps", [((2, 8), 3), ((1, 5), 1)])
def test_time_fn_per_iter_differences_chain_lengths(monkeypatch, iters, reps):
    clock = FakeClock(per_call=0.25, per_read=1.5)
    monkeypatch.setattr(timing, "time", SimpleNamespace(perf_counter=clock.perf_counter))
    x = torch.ones(4)
    per_iter = timing.time_fn_per_iter(clock.fn, (x,), iters=iters, reps=reps)
    # the reads' fixed cost cancels: only the calls' 0.25 s each remain
    assert per_iter == pytest.approx(0.25, rel=1e-12)
    n1, n2 = iters
    assert clock.calls == (n1 + n2) * (1 + reps)  # warm-up, then reps of each chain
    with pytest.raises(ValueError, match="n2 > n1"):
        timing.time_fn_per_iter(clock.fn, (x,), iters=(3, 3))


def test_time_fn_total_is_one_call_and_its_fetch(monkeypatch):
    clock = FakeClock(per_call=0.25, per_read=1.5)
    monkeypatch.setattr(timing, "time", SimpleNamespace(perf_counter=clock.perf_counter))
    assert timing.time_fn_total(clock.fn, (torch.ones(2),), reps=2) == pytest.approx(1.75)
    assert clock.calls == 3


def test_host_roundtrip_wants_cuda_unless_asked_for_the_cpu():
    assert timing.host_roundtrip_seconds(reps=2, device="cpu") > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA requested"):
            timing.host_roundtrip_seconds(reps=1)


def test_enable_compilation_cache_moves_the_libraries(tmp_path, monkeypatch):
    monkeypatch.setattr(gk, "BUILD_DIR", gk.BUILD_DIR)  # restored after the test
    before = gk._lib_path("train_fwd")
    assert before.parent == gk.DEFAULT_BUILD_DIR
    got = cache.enable_compilation_cache(tmp_path / "kernels")
    assert got == tmp_path / "kernels" and got.is_dir()
    moved = gk._lib_path("train_fwd")
    assert moved == got / before.name  # the same content-hashed name
    assert cache.enable_compilation_cache() == gk.DEFAULT_BUILD_DIR
    assert gk._lib_path("train_fwd") == before


TINY = ["--device", "cpu", "--batch", "3", "--time", "12", "--hidden", "8", "--input", "5"]


@pytest.mark.parametrize("shared", [True, False])
def test_bench_scan_equals_jax_gsu_stack_apply(shared):
    args = bench_gsu_kernel.parse(TINY + ([] if shared else ["--no-shared"]))
    params, state, x = bench_gsu_kernel.build_inputs(args, torch.device("cpu"))
    # in float64, where the two scans' sums in another order flip no spike
    params = {"layers": [{k: v.double() for k, v in lp.items()} for lp in params["layers"]]}
    x = x.double()
    got = bench_gsu_kernel.scan_forward(params, state, x, args.hidden, shared)
    jp = {"layers": [{k: jnp.asarray(v.numpy()) for k, v in lp.items()}
                     for lp in params["layers"]]}
    want = jax_gsu_stack_apply(jp, {"layers": [{}]}, jnp.asarray(x.numpy()),
                               hidden_size=args.hidden, shared_weights=shared, train=False)[0]
    assert got.shape == (12, 3, 8) and float(got.sum()) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # kernel D's plain version (the CPU route) gives the same spikes
    assert torch.equal(bench_gsu_kernel.kernel_forward(params, x, args.hidden, shared), got)


def test_bench_runs_on_the_cpu(capsys):
    res = bench_gsu_kernel.main(TINY + ["--train", "--t-blk", "8", "16"])
    assert res["kernel_fwd"]["max_abs_diff"] == 0.0
    assert all(v < 1e-6 for v in res["kernel_grad"]["rel_l2_vs_scan"])
    assert all(v == 0.0 for v in res["checks"].values())
    # the plain versions launch nothing; each timed chain calls the kernels
    assert res["launches"] == {"D": 0, "E": 0, "dW": 0}
    assert res["calls"] == {"D": 82, "E": 41, "dW": 41}
    out = capsys.readouterr().out
    assert "kernel D fwd" in out and "us/frame" in out


def test_profile_trace_writes_a_trace_and_a_summary(tmp_path):
    res = profile_trace.main(["--device", "cpu", "--batch", "1", "--seconds", "0.05",
                              "--serving", "--trace-dir", str(tmp_path / "trace"),
                              "--summary", str(tmp_path / "summary.md")])
    assert set(res["profiles"]) == {"forward", "train_step"}
    for name, prof in res["profiles"].items():
        trace = json.loads(Path(prof["trace"]).read_text())
        assert trace["traceEvents"], name
        assert prof["rows"] and prof["launches"] == {}
        assert prof["total_ms"] == pytest.approx(sum(r[1] for r in prof["rows"]))
    md = (tmp_path / "summary.md").read_text()
    assert "## forward" in md and "## train_step" in md and "| self CPU ms | calls | op |" in md
    assert res["analytic"]["gflop_per_audio_second"] > 0
    assert profile_trace.kernel_calls([("void monolith_kernel<float>(MonoArgs)", 1.0, 3),
                                       ("aten::mm", 2.0, 9)], "sfsb_monolith_serve") == 3
