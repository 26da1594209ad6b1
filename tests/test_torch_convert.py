"""The port's weight loading, module tree, device policy and import hygiene."""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from spiking_fullsubnet_tpu.models.spiking_fullsubnet import (
    separator_config as jax_separator_config,
    spiking_fullsubnet_init,
)
from spiking_fullsubnet_tpu.runtime.convert import load_npz as jax_load_npz

from spiking_fullsubnet_torch.models.presets import flagship_m
from spiking_fullsubnet_torch.models.spiking_fullsubnet import SpikingFullSubNet, separator_config
from spiking_fullsubnet_torch.runtime.convert import load_npz, params_from_numpy
from spiking_fullsubnet_torch.runtime.device import resolve_device

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
