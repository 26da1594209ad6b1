"""CPU tests of the benchmark harness: it finds every cell, configuration and
metric from its files; a cell added as new files runs; the traffic repeats
for a seed; the copied work counts equal the program's; the reference agrees
with the program's plain CPU path; and nothing here imports JAX or the JAX
package, nor the reference the program."""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import time
from pathlib import Path

import pytest
import torch

from gpubench import harness, reference, traffic, weights, work
from gpubench.tests.tiny import REPO, TINY_MODEL, tiny_root

BENCH = REPO / "gpubench"
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_is_well_formed():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert SPEC["paths"] == ["gpubench"] and SPEC["command"][1] == "gpubench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(names) == len(set(names))
    for w in SPEC["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] in (1, 4)
        cell = harness.Cell(REPO, w["name"])
        assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
        assert cell.per_layer
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in names and w in [c for c in e2e[m["moves"]].get("workloads", names)]


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_harness_finds_each_cell_from_its_files(workload):
    cell = harness.Cell(REPO, workload)
    assert callable(cell.runner().run)
    assert "enh_prefix_err" in cell.limits and len(cell.limits) >= 2
    assert set(cell.limits) <= set(harness.check.NUMBERS)
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
    cfg = harness.program_config(cell, cell.mode)
    assert cfg.compute_dtype == cell.config[cell.mode]["compute_dtype"]


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_each_metric_reader_is_its_own_file_and_reads_nothing_from_an_empty_trace(metric):
    cell = harness.Cell(REPO, SPEC["workloads"][0]["name"])
    read = cell.reader(metric)
    ctx = {"mode": "serve", "geom": cell.geom, "config": cell.config, "traffic": cell.traffic,
           "chips": 1, "units": 0, "window_s": 1.0, "audio_s_per_s": 0.0, "kernels": [],
           "busy_s": 0.0, "work": work}
    assert read(ctx) is None


def test_a_cell_added_as_new_files_runs_on_the_cpu(tmp_path):
    root = tiny_root(tmp_path)
    lines = []
    line = harness.run(root, "tiny.serve", 2 ** 31 + 11, 0.2, False, time.perf_counter(),
                       device=torch.device("cpu"), emit=lines.append)
    assert json.loads(lines[-1]) == line
    assert line["correct"] is True and line["attempted"] >= 2
    assert set(line["metrics"]) == {"enhance_audio_s_per_s", "enhance_batch_ms_p50", "setup_s"}
    assert list(line)[-1] == "checks"


MIXED = '''
"""Test generator: utterances of mixed lengths, zero-padded to the longest,
held on the host."""
import torch

REQUIRED = ("batch", "lengths_s")


def make_batch(spec, seed, index, device):
    sr = spec["sample_rate"]
    n = [int(s * sr) for s in spec["lengths_s"]]
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 31 + index)
    x = torch.randn(spec["batch"], max(n), generator=gen, device=device).cpu() * 0.1
    for r in range(spec["batch"]):
        x[r, n[r % len(n)]:] = 0.0
    audio = sum(n[r % len(n)] for r in range(spec["batch"])) / sr
    return {"noisy": x, "clean": x.clone(), "audio_s": audio}
'''


def test_a_mix_of_a_new_shape_is_a_new_generator_file(tmp_path):
    root = tiny_root(tmp_path)
    bench = root / "gpubench"
    (bench / "generators" / "mixed_lengths.py").write_text(MIXED)
    mix = {"mode": "serve", "generator": "mixed_lengths", "sample_rate": 16000, "pool": 2,
           "check_rows": 2, "batch": 3, "lengths_s": [0.05, 0.1, 0.15]}
    (bench / "traffic" / "tiny_mixed.json").write_text(json.dumps(mix))
    (bench / "cells" / "tiny.mixed.json").write_text(
        (bench / "cells" / "tiny.serve.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny.mixed", "config": "tiny", "traffic": "tiny_mixed",
                              "chips": 1, "why": "tests"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.mixed")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    line = harness.run(root, "tiny.mixed", 2 ** 31 + 13, 0.2, False, time.perf_counter(),
                       device=torch.device("cpu"), emit=lambda s: None)
    assert line["correct"] is True and line["attempted"] >= 2
    rate = line["metrics"]["enhance_audio_s_per_s"]["value"]
    assert rate > 0


def test_segment_rms_sees_a_lost_segment_and_not_a_parted_realisation():
    gen = torch.Generator().manual_seed(9)
    ref = torch.randn(8, 4000, generator=gen)
    other = torch.randn(8, 4000, generator=gen)  # same level, other values
    cell = {"segment_samples": 500, "prefix_samples": 1000}
    assert harness.check.segment_rms_err(other, ref, cell) < 0.2
    assert harness.check.wave_err(other, ref, cell) > 1.0
    lost = ref.clone()
    lost[:, 3500:] = 0.0
    assert harness.check.segment_rms_err(lost, ref, cell) > 0.9
    assert harness.check.prefix_err(lost, ref, cell) == 0.0


def test_traffic_is_the_same_for_the_same_seed():
    spec = dict(traffic.load(BENCH / "traffic" / "serve.b256x30s.json"), batch=3, seconds=0.05)
    big = 2 ** 31 + 17
    a, d = traffic.make_pool(dict(spec, pool=2), big, torch.device("cpu"))
    b = traffic.make_pool(dict(spec, pool=1), big, torch.device("cpu"))[0]
    c = traffic.make_pool(dict(spec, pool=1), big + 1, torch.device("cpu"))[0]
    assert torch.equal(a["noisy"], b["noisy"]) and torch.equal(a["clean"], b["clean"])
    assert not torch.equal(a["noisy"], c["noisy"]) and not torch.equal(a["noisy"], d["noisy"])
    assert a["noisy"].shape == (3, 800) and a["audio_s"] == pytest.approx(0.15)


@pytest.mark.parametrize("config", ["flagship_m", "zoo_m"])
def test_copied_flops_equal_the_programs_roofline(config):
    from spiking_fullsubnet_torch.runtime.roofline import spiking_fullsubnet_cost

    cfgfile = json.loads((BENCH / "configs" / f"{config}.json").read_text())
    cell = next(harness.Cell(REPO, w["name"]) for w in SPEC["workloads"]
                if w["config"] == config)
    g = reference.geometry(cfgfile["factory"], cfgfile["model_args"])
    cost = spiking_fullsubnet_cost(harness.program_config(cell, "serve"))
    assert work.model_flops_per_audio_second(g, 16000) == pytest.approx(
        cost.flops_per_audio_second(), rel=1e-12)


def test_flagship_has_the_published_parameter_count():
    cfg = json.loads((BENCH / "configs" / "flagship_m.json").read_text())
    g = reference.geometry(cfg["factory"], cfg["model_args"])
    n = sum(torch.Size(shape).numel() for path, shape, _ in weights.leaf_specs(g)
            if path.startswith("params/"))
    assert 940_000 < n < 970_000


def _f64(tree):
    return weights.tree_from_paths({k: v.double() for k, v in weights.flatten(
        {"params": tree[0], "state": tree[1]}).items()})


SEPARATOR = dict(sr=16000, fdrc=0.5, n_fft=64, fb_freqs=8, hop_length=16, win_length=64,
                 num_freqs=32, sequence_model="GSU", fb_hidden_size=12,
                 fb_output_activate_function=False, freq_cutoffs=[8, 16], sb_df_orders=[3, 2, 1],
                 sb_num_center_freqs=[2, 4, 8], sb_num_neighbor_freqs=[2, 2, 2],
                 fb_num_center_freqs=[2, 4, 8], fb_num_neighbor_freqs=[0, 0, 0],
                 sb_hidden_size=10, sb_output_activate_function=False,
                 norm_type="offline_laplace_norm", shared_weights=True, bn=True)


def _program_cfg(factory, args):
    from spiking_fullsubnet_torch.models import spiking_fullsubnet as sfs

    if factory == "build_separator":
        return sfs.separator_config(**args)
    return sfs.SpikingFullSubNetConfig(**{
        k: tuple(v) if isinstance(v, list) else None if v is False and k.endswith("function")
        else v for k, v in args.items()})


@pytest.mark.parametrize("factory,args", [("build", TINY_MODEL), ("build_separator", SEPARATOR)])
def test_reference_agrees_with_the_programs_cpu_path_in_eval(factory, args):
    from spiking_fullsubnet_torch.models.spiking_fullsubnet import spiking_fullsubnet_apply

    g = reference.geometry(factory, args)
    params, state = _f64(weights.seeded(g, 5, torch.device("cpu")))
    cfg = dataclasses.replace(_program_cfg(factory, args), scan_mode="layered")
    x = torch.randn(3, 2400, dtype=torch.float64, generator=torch.Generator().manual_seed(1)) * 0.3
    prog = spiking_fullsubnet_apply(cfg, params, state, x, train=False)["enhanced_y"]
    ref = reference.forward(g, params, state, x)
    assert (prog - ref).abs().max() < 1e-6 * ref.abs().max()


@pytest.mark.parametrize("quant,bits", [("tf32", 10), ("bfloat16", 7)])
def test_the_controls_rounding_keeps_the_stated_mantissa(quant, bits):
    x = torch.randn(4096, generator=torch.Generator().manual_seed(4), dtype=torch.float32)
    y = reference.Ops(quant).round(x)
    rel = ((y - x) / x).abs().max().item()
    assert 2.0 ** -(bits + 3) < rel <= 2.0 ** -(bits + 1) * 1.0001


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")
                                        if "_cache" not in p.parts))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(BENCH / path)}
    assert not tops & {"jax", "jaxlib", "flax", "spiking_fullsubnet_tpu"}


@pytest.mark.parametrize("module", ["reference", "check", "weights", "traffic", "work",
                                    "generators/tones"])
def test_the_yardstick_imports_nothing_of_the_program(module):
    tops = {name.split(".")[0] for name in _imports(BENCH / f"{module}.py")}
    assert "spiking_fullsubnet_torch" not in tops
