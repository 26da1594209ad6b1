"""The port's weight loading, module tree, device policy and import hygiene."""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from spiking_fullsubnet_tpu.models.spiking_fullsubnet import (
    SpikingFullSubNetConfig as JaxConfig, spiking_fullsubnet_apply as jax_apply)
from spiking_fullsubnet_tpu.runtime import convert as JCV
from spiking_fullsubnet_tpu.models.spiking_fullsubnet import (
    separator_config as jax_separator_config,
    spiking_fullsubnet_init,
)
from spiking_fullsubnet_tpu.runtime.convert import load_npz as jax_load_npz

from spiking_fullsubnet_torch.models import discriminator as PD
from spiking_fullsubnet_torch.models.presets import flagship_m
from spiking_fullsubnet_torch.models.spiking_fullsubnet import (
    SpikingFullSubNet, SpikingFullSubNetConfig, separator_config, spiking_fullsubnet_apply)
from spiking_fullsubnet_torch.runtime import cli
from spiking_fullsubnet_torch.runtime import config as PC
from spiking_fullsubnet_torch.runtime import convert as PCV
from spiking_fullsubnet_torch.runtime.convert import load_npz, params_from_numpy
from spiking_fullsubnet_torch.runtime.device import resolve_device
from spiking_fullsubnet_torch.tools import convert_checkpoint

ROOT = Path(__file__).resolve().parent.parent
ZOO_M = ROOT / "model_zoo" / "intel_ndns" / "spike_fsb" / "baseline_m.npz"
ZOO_KW = dict(norm_type="offline_laplace_norm", shared_weights=True, bn=True)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, x in tree.items() for k2, v in _flat(x, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v for i, x in enumerate(tree) for k2, v in _flat(x, f"{prefix}{i}/").items()}
    # the module's weights are trainable parameters: detach before numpy
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


def test_load_npz_matches_jax_loader():
    cfg = jax_separator_config(**ZOO_KW)
    tpl = spiking_fullsubnet_init(jax.random.PRNGKey(0), cfg)
    ref = _flat(jax_load_npz(str(ZOO_M), {"params": tpl[0], "state": tpl[1]}))
    tree = load_npz(str(ZOO_M), device="cpu")
    assert isinstance(tree["params"]["sb"], list)
    assert isinstance(tree["params"]["fb"]["stack"]["layers"], list)
    got = _flat(tree)
    assert sorted(got) == sorted(ref) and len(got) == 64
    assert sum(v.size for v in got.values()) == 957_672
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_params_from_numpy_keeps_nesting_and_values():
    cfg = jax_separator_config(**ZOO_KW, fb_hidden_size=16, sb_hidden_size=12)
    params, state = spiking_fullsubnet_init(jax.random.PRNGKey(1), cfg)
    p_np = jax.tree.map(lambda x: np.asarray(x, np.float64), params)
    tp = params_from_numpy(p_np, device="cpu")
    assert isinstance(tp["sb"], list) and isinstance(tp["fb"]["stack"]["layers"], list)
    ref, got = _flat(p_np), _flat(tp)
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert got[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], ref[k])


def test_module_holds_weights_under_jax_paths():
    model = SpikingFullSubNet.from_npz(str(ZOO_M), separator_config(**ZOO_KW), device="cpu")
    with np.load(ZOO_M) as data:
        keys = {k.replace("/", ".") for k in data.files}
    sd = model.state_dict()
    assert set(sd) == keys
    assert sd["state.fb.stack.layers.1.bn.running_var"].shape == (320,)
    assert isinstance(model.params.fb.stack.layers[0].weight_hh, torch.nn.Parameter)
    assert _flat(model.param_tree()).keys() == _flat(load_npz(str(ZOO_M), "cpu")["params"]).keys()


def test_entry_points_default_to_cuda_and_never_fall_back():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(dev)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_npz(str(ZOO_M))
    with pytest.raises(RuntimeError, match="CUDA"):
        flagship_m()
    with pytest.raises(RuntimeError, match="CUDA"):
        SpikingFullSubNet.from_init(separator_config(**ZOO_KW), seed=0)


# JAX, the JAX package, pandas (not on the card's machine) and a recipe
# directory's trainer modules (trainer.py, trainer_GAN.py, ...: they import
# the JAX package)
_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|spiking_fullsubnet_tpu|pandas|trainer\w*)\b",
                     re.M)


def test_port_and_chip_smoke_import_no_jax():
    files = sorted((ROOT / "spiking_fullsubnet_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    rel = {f.relative_to(ROOT).as_posix() for f in files}
    assert {"spiking_fullsubnet_torch/runtime/cli.py", "spiking_fullsubnet_torch/runtime/trainer.py",
            "spiking_fullsubnet_torch/data/loader.py", "spiking_fullsubnet_torch/metrics/metrics.py",
            "spiking_fullsubnet_torch/recipes/denoise.py"} <= rel
    for f in files:
        assert not _IMPORT.search(f.read_text()), f"{f} imports JAX, the JAX package, pandas or a " \
                                                  "recipe's trainer"
    mods = [".".join(f.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
            for f in files]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'spiking_fullsubnet_tpu', 'pandas') "
              "or m.split('.')[0].startswith('trainer')]\n"
            + "assert not bad, bad\nprint('CLEAN')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert "CLEAN" in out.stdout, out.stdout + out.stderr



# ------------------------------------------------------------------ the reference-checkpoint import

SFS_RECIPE = ROOT / "recipes" / "intel_ndns" / "spiking_fullsubnet"
TINY_WIDTHS = dict(fb_hidden_size=24, sb_hidden_size=16)


def _reference_sd(params, state, generation, prefix="module."):
    """The weights under the reference's key names (the import's map read
    backwards): "frozen" names the projection ``fc_output_layer``, "latest"
    ``proj`` (with ``pre_layer_norm``), numpy float32 -> torch tensors."""
    sd = {}

    def seq(p, st, name):
        if "pre_ln" in p:
            for k in ("weight", "bias"):
                sd[f"{name}.pre_layer_norm.{k}"] = p["pre_ln"][k]
        for i, (lp, ls) in enumerate(zip(p["stack"]["layers"], st["stack"]["layers"])):
            cp = f"{name}.sequence_model.layers.{i}.cell"
            for k in ("weight_ih", "weight_hh", "bias_ih"):
                sd[f"{cp}.{k}"] = lp[k]
            for k in ("weight", "bias"):
                sd[f"{cp}.batchnorm.{k}"] = lp["bn"][k]
            for k in ("running_mean", "running_var"):
                sd[f"{cp}.batchnorm.{k}"] = ls["bn"][k]
        proj = "fc_output_layer" if generation == "frozen" else "proj"
        for k in ("weight", "bias"):
            sd[f"{name}.{proj}.{k}"] = p["proj"][k]

    seq(params["fb"], state["fb"], "fb_model")
    for i, (p, st) in enumerate(zip(params["sb"], state["sb"])):
        seq(p, st, f"sb_model.sb_models.{i}")
    return {prefix + k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}


def _generation(generation):
    """(JAX config, port config, random float32 weights) of a tiny model of
    the generation: the frozen Separator (offline norm, no pre-LN) or the
    latest (pre-LN, no norm)."""
    if generation == "frozen":
        jcfg = jax_separator_config(**ZOO_KW, **TINY_WIDTHS)
        pcfg = separator_config(**ZOO_KW, **TINY_WIDTHS)
    else:
        kw = dict(**TINY_WIDTHS, bn=True, shared_weights=True)
        jcfg, pcfg = JaxConfig(**kw), SpikingFullSubNetConfig(**kw)
    params, state = spiking_fullsubnet_init(jax.random.PRNGKey(7), jcfg)
    params, state = (jax.tree.map(lambda x: np.asarray(x, np.float32), t) for t in (params, state))
    return jcfg, pcfg, params, state


@pytest.mark.parametrize("generation", ["frozen", "latest"])
def test_import_matches_jax_import_leaf_for_leaf(generation, tmp_path):
    jcfg, pcfg, params, state = _generation(generation)
    path = tmp_path / "pytorch_model.bin"
    torch.save({"state_dict": _reference_sd(params, state, generation)}, path)
    jp, js = JCV.import_spiking_fullsubnet(JCV.load_torch_state_dict(str(path)), jcfg)
    pp, ps = PCV.import_spiking_fullsubnet(PCV.load_torch_state_dict(str(path), "cpu"), pcfg)
    for got, want in ((pp, jp), (ps, js)):
        got, want = _flat(got), _flat(want)
        assert list(got) == list(want)  # the same leaves in the same order
        for k in want:
            assert np.array_equal(got[k], want[k]), k
    assert ("fb/pre_ln/weight" in _flat(pp)) == (generation == "latest")
    # both packages' forwards on the imported weights: the layered path in float32
    noisy = (np.random.default_rng(3).standard_normal((1, 2000)) * 0.1).astype(np.float32)
    ref = np.asarray(jax.jit(lambda x: jax_apply(jcfg, jp, js, x)["enhanced_y"])(
        jnp.asarray(noisy)))
    out = spiking_fullsubnet_apply(pcfg, pp, ps, torch.from_numpy(noisy))["enhanced_y"].numpy()
    assert 10 * np.log10(np.sum(ref ** 2) / np.sum((out - ref) ** 2)) > 60


def test_load_torch_state_dict_takes_the_reference_forms(tmp_path):
    _, _, params, state = _generation("frozen")
    sd = _reference_sd(params, state, "frozen", prefix="")
    module = torch.nn.Module()
    module.register_buffer("w", torch.ones(2))
    for name, obj, want in (("flat.pt", sd, sd), ("wrapped.pt", {"state_dict": sd}, sd),
                            ("module.pt", module, {"w": torch.ones(2)})):
        torch.save(obj, tmp_path / name)
        got = PCV.load_torch_state_dict(str(tmp_path / name), device="cpu")
        assert list(got) == list(want)
        assert all(torch.equal(got[k], want[k]) for k in want)


def test_import_discriminator_matches_jax():
    shapes = PD.discriminator_init(torch.Generator().manual_seed(0), ndf=16)
    rng = np.random.default_rng(5)
    draw = lambda t: torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))  # noqa: E731
    sd = {}
    for j in range(4):
        conv = shapes["convs"][j]
        sd[f"module.layers.{3 * j}.weight_orig"] = draw(conv["weight"])
        sd[f"module.layers.{3 * j}.weight_u"] = draw(conv["u"])
        sd[f"module.layers.{3 * j}.weight_v"] = draw(conv["v"])
        sd[f"module.layers.{3 * j + 1}.weight"] = draw(shapes["inorm"][j]["weight"])
        sd[f"module.layers.{3 * j + 1}.bias"] = draw(shapes["inorm"][j]["bias"])
        sd[f"module.layers.{3 * j + 2}.weight"] = draw(shapes["prelu"][j])
    for name, idx in (("fc1", 14), ("fc2", 17)):
        for k, ref_k in (("weight", "weight_orig"), ("bias", "bias"), ("u", "weight_u"),
                         ("v", "weight_v")):
            sd[f"module.layers.{idx}.{ref_k}"] = draw(shapes[name][k])
    sd["module.layers.16.weight"] = draw(shapes["prelu_fc"])
    sd["module.layers.18.slope"] = draw(shapes["sigmoid_slope"])
    ref = _flat(JCV.import_discriminator({k: v.numpy() for k, v in sd.items()}, ndf=16))
    got = _flat(PCV.import_discriminator(sd, ndf=16))
    assert sorted(got) == sorted(ref)
    assert list(got) == list(_flat(shapes))  # the port's tree, in its order
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


def test_save_npz_is_read_exactly_by_both_loaders(tmp_path):
    jcfg, pcfg, params, state = _generation("latest")
    tree = {"params": params_from_numpy(params, "cpu"), "state": params_from_numpy(state, "cpu")}
    PCV.save_npz(str(tmp_path / "w.npz"), tree)
    tpl = spiking_fullsubnet_init(jax.random.PRNGKey(0), jcfg)
    by_jax = _flat(jax_load_npz(str(tmp_path / "w.npz"), {"params": tpl[0], "state": tpl[1]}))
    by_port = _flat(load_npz(str(tmp_path / "w.npz"), device="cpu"))
    want = _flat({"params": params, "state": state})
    assert sorted(by_jax) == sorted(by_port) == sorted(want)
    for k in want:
        assert np.array_equal(by_jax[k], want[k]) and np.array_equal(by_port[k], want[k]), k
    # and the JAX package's save_npz is read exactly by the port's loader
    JCV.save_npz(str(tmp_path / "j.npz"), {"params": params, "state": state})
    got = _flat(load_npz(str(tmp_path / "j.npz"), device="cpu"))
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_converter_cli_matches_the_jax_converter(tmp_path, monkeypatch):
    import importlib.util

    toml = SFS_RECIPE / "tiny_synthetic.toml"
    model_args = PC.toml_load(toml)["model"]["args"]
    jcfg = JaxConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model_args.items()
                        if k != "fb_output_activate_function"})
    params, state = spiking_fullsubnet_init(jax.random.PRNGKey(2), jcfg)
    params, state = (jax.tree.map(lambda x: np.asarray(x, np.float32), t) for t in (params, state))
    ckpt = tmp_path / "pytorch_model.bin"
    torch.save(_reference_sd(params, state, "latest"), ckpt)
    convert_checkpoint.main(["--torch_ckpt", str(ckpt), "--config", str(toml),
                             "--output", str(tmp_path / "port.npz"), "--device", "cpu"])
    spec = importlib.util.spec_from_file_location("jax_convert_checkpoint",
                                                  ROOT / "tools" / "convert_checkpoint.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint", "--torch_ckpt", str(ckpt), "--config",
                                      str(toml), "--output", str(tmp_path / "jax.npz")])
    tool.main()
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in b.files)
    want = _flat({"params": params, "state": state})
    got = _flat(load_npz(str(tmp_path / "port.npz"), device="cpu"))
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_cli_test_mode_runs_on_the_imported_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    shutil.copy(SFS_RECIPE / "tiny_synthetic.toml", tmp_path / "tiny_synthetic.toml")
    model_args = PC.toml_load(tmp_path / "tiny_synthetic.toml")["model"]["args"]
    jcfg = JaxConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in model_args.items()
                        if k != "fb_output_activate_function"})
    params, state = spiking_fullsubnet_init(jax.random.PRNGKey(4), jcfg)
    params, state = (jax.tree.map(lambda x: np.asarray(x, np.float32), t) for t in (params, state))
    ckpt = tmp_path / "pytorch_model.bin"
    torch.save(_reference_sd(params, state, "latest"), ckpt)
    with pytest.raises(ValueError, match="checkpoint path is required"):
        cli.main(["-C", "tiny_synthetic.toml", "-M", "test", "--device", "cpu"],
                 recipe_dir=SFS_RECIPE)
    t = cli.main(["-C", "tiny_synthetic.toml", "-M", "test", "--torch_ckpt", str(ckpt),
                  "--device", "cpu"], recipe_dir=SFS_RECIPE)
    want_p, want_s = PCV.import_spiking_fullsubnet(PCV.load_torch_state_dict(str(ckpt), "cpu"),
                                                   t.model_config)
    for got, want in ((t.params, want_p), (t.model_state, want_s)):
        got, want = _flat(got), _flat(want)
        assert sorted(got) == sorted(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)
    assert all(w is p for w, p in zip(t.weights, PCV.flat_paths(t.params).values()))
    metrics = sorted((tmp_path / "exp" / "tiny_synthetic" / "metrics").glob("*_mean.csv"))
    assert metrics  # the test ran on the imported weights and wrote its scores


def test_serving_entry_points_want_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the default device is usable")
    torch.save({"w": torch.ones(1)}, tmp_path / "sd.pt")
    with pytest.raises(RuntimeError, match="CUDA"):
        PCV.load_torch_state_dict(str(tmp_path / "sd.pt"))
    with pytest.raises(RuntimeError, match="CUDA"):
        convert_checkpoint.main(["--torch_ckpt", str(tmp_path / "sd.pt"), "--config",
                                 str(SFS_RECIPE / "tiny_synthetic.toml"), "--output",
                                 str(tmp_path / "x.npz")])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["-C", str(SFS_RECIPE / "tiny_synthetic.toml"), "-M", "test", "--torch_ckpt",
                  str(tmp_path / "sd.pt")])
