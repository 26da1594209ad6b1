"""The port's experiment runtime against spiking_fullsubnet_tpu.runtime.

The TOML loader and writer on every recipe; the warm-up schedules (every
update's learning rate, rtol 1e-12); one optimizer update from the
registry against optax in float64 (rtol 1e-10); the registry's path
mapping and its refusals; the trainer's counters; the checkpoint
directories, their rotation and resolution.
"""

from __future__ import annotations

import glob
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from spiking_fullsubnet_tpu.runtime import config as JC
from spiking_fullsubnet_tpu.runtime import optimization as JO
from spiking_fullsubnet_tpu.runtime.registry import build_optimizer_factory as jax_optimizer
from spiking_fullsubnet_tpu.runtime.trainer_state import TrainerState as JaxTrainerState

from spiking_fullsubnet_torch.data import SyntheticNoisyDataset
from spiking_fullsubnet_torch.runtime import config as PC
from spiking_fullsubnet_torch.runtime import optimization as PO
from spiking_fullsubnet_torch.runtime import registry
from spiking_fullsubnet_torch.runtime.checkpoint import CheckpointManager
from spiking_fullsubnet_torch.runtime.trainer_state import TrainerState

ROOT = Path(__file__).resolve().parent.parent
TOMLS = sorted(glob.glob(str(ROOT / "recipes" / "**" / "*.toml"), recursive=True))


def _empty_tables(tree, prefix=""):
    """The dotted names of the empty tables of a config."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            name = f"{prefix}.{k}" if prefix else k
            out += [name] if not v else _empty_tables(v, name)
    return out


def _has_array_of_tables(tree):
    return any((isinstance(v, list) and v and isinstance(v[0], dict))
               or (isinstance(v, dict) and _has_array_of_tables(v)) for v in tree.values())


@pytest.mark.parametrize("path", TOMLS, ids=lambda p: str(Path(p).relative_to(ROOT / "recipes")))
def test_toml_load_and_dump_match_jax(path, tmp_path):
    """The port's snapshot is JAX's text plus the headers of the empty
    tables, which the JAX writer drops; where the config holds an array of
    tables the two differ on purpose (the JAX writer's items lose their
    prefix), and the port's loads back (``test_toml_dump_loads_back``)."""
    cfg = PC.toml_load(path)
    assert cfg == JC.toml_load(path)
    PC.toml_dump(cfg, tmp_path / "port.toml")
    JC.toml_dump(cfg, tmp_path / "jax.toml")
    port, jax_text = (tmp_path / "port.toml").read_text(), (tmp_path / "jax.toml").read_text()
    if _has_array_of_tables(cfg):
        assert port != jax_text
        return
    for name in _empty_tables(cfg):
        assert f"[{name}]\n\n" in port
        port = port.replace(f"[{name}]\n\n", "", 1)
    assert port == jax_text


@pytest.mark.parametrize("path", TOMLS, ids=lambda p: str(Path(p).relative_to(ROOT / "recipes")))
def test_toml_dump_loads_back(path, tmp_path):
    cfg = PC.toml_load(path)
    PC.toml_dump(cfg, tmp_path / "port.toml")
    assert PC.toml_load(tmp_path / "port.toml") == cfg


def test_toml_env_interpolation_matches_jax(monkeypatch):
    monkeypatch.setenv("SFS_DATA", "/data/dns")
    text = 'a = "${SFS_DATA}/train"\nb = ["$SFS_DATA", "$NOT_SET_ANYWHERE"]\n[c]\nd = "x"\n'
    got = PC.toml_loads(text, interpolate_env=True)
    assert got == JC.toml_loads(text, interpolate_env=True)
    assert got["a"] == "/data/dns/train" and got["b"] == ["/data/dns", "$NOT_SET_ANYWHERE"]
    assert PC.toml_loads(text)["a"] == "${SFS_DATA}/train"


SCHEDULES = [
    ("get_constant_schedule_with_warmup", (1e-3, 7)),
    ("get_constant_schedule_with_warmup", (3e-4, 0)),
    ("get_linear_schedule_with_warmup", (1e-3, 5, 40)),
    ("get_linear_schedule_with_warmup", (5e-4, 0, 30)),
    ("get_exponential_schedule", (1e-3, 0.97, 3)),
    ("get_exponential_schedule", (5e-4, 0.99, 1)),
]


@pytest.mark.parametrize("name,args", SCHEDULES, ids=lambda v: str(v))
def test_schedule_matches_jax_at_every_update(name, args):
    js, ps = getattr(JO, name)(*args), getattr(PO, name)(*args)
    got = np.array([ps(n) for n in range(51)])
    ref = np.array([float(js(n)) for n in range(51)])
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=0)


@pytest.mark.parametrize("max_steps,ratio,warmup", [(100, 0.1, 0), (33, 0.25, 0), (50, 0.5, 4)])
def test_warmup_steps_and_create_match_jax(max_steps, ratio, warmup):
    n = PO.get_warmup_steps(warmup, max_steps, ratio)
    assert n == JO.get_warmup_steps(warmup, max_steps, ratio)
    for name in ("constant_schedule_with_warmup", "linear_schedule_with_warmup"):
        ps = PO.create_warmup_schedule(name, 1e-3, max_steps, n)
        js = JO.create_warmup_schedule(name, 1e-3, max_steps, n)
        assert [ps(k) for k in range(max_steps)] == [float(js(k)) for k in range(max_steps)]
    with pytest.raises(ValueError, match="Unknown scheduler"):
        PO.create_warmup_schedule("cosine", 1e-3, max_steps, n)


OPTIMIZERS = [
    ("torch.optim.AdamW", {"lr": 1e-3}),
    ("torch.optim.AdamW", {"lr": 2e-3, "betas": [0.8, 0.99], "eps": 1e-6, "weight_decay": 0.05}),
    ("torch.optim.Adam", {"lr": 2e-3, "amsgrad": False}),
    ("torch.optim.SGD", {"lr": 0.1}),
    ("torch.optim.SGD", {"lr": 0.05, "momentum": 0.9}),
]


@pytest.mark.parametrize("path,args", OPTIMIZERS, ids=lambda v: str(v))
def test_optimizer_updates_match_optax_f64(path, args):
    """Two updates from the same float64 tree and gradients: the second
    reads the first's moments and bias corrections."""
    rng = np.random.default_rng(11)
    shapes = [(5, 3), (7,), (2, 4, 3)]
    params = [rng.standard_normal(s) for s in shapes]
    grads = [[rng.standard_normal(s) for s in shapes] for _ in range(2)]

    factory, lr = jax_optimizer(path, args)
    tx = factory(lr)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    pfactory, plr = registry.build_optimizer_factory(path, args)
    assert plr == lr
    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in params]
    opt = pfactory(tp)
    for g in grads:
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x.copy())
        opt.step()
    for t, r, p0 in zip(tp, jp, params):
        assert t.dtype == torch.float64
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(r), rtol=1e-10, atol=0)
        assert np.abs(np.asarray(r) - p0).max() > 1e-4


def test_registry_maps_jax_paths_and_names_what_is_not_ported():
    ds = registry.instantiate("spiking_fullsubnet_tpu.data.SyntheticNoisyDataset",
                              {"num_samples": 3, "duration": 0.1})
    assert isinstance(ds, SyntheticNoisyDataset) and len(ds) == 3
    from spiking_fullsubnet_torch.models import spiking_fullsubnet, cirm_models
    assert registry.resolve("spiking_fullsubnet_tpu.models.spiking_fullsubnet.build_separator") \
        is spiking_fullsubnet.build_separator
    assert registry.resolve("spiking_fullsubnet_tpu.models.cirm_models.build") is cirm_models.build
    from spiking_fullsubnet_torch.losses import mse_loss
    assert registry.instantiate("torch.nn.MSELoss", initialize=False) is mse_loss
    # the discriminator, the GAN trainers and the fused forward resolve in the port
    from spiking_fullsubnet_torch.models import discriminator, fused_forward
    from spiking_fullsubnet_torch.recipes import gan
    assert registry.resolve("spiking_fullsubnet_tpu.models.discriminator.build") \
        is discriminator.build
    for name in ("GanDenoiseTrainer", "DualGanDenoiseTrainer", "OnlyGenTrainer",
                 "build_discriminator_bundles"):
        assert registry.resolve(f"spiking_fullsubnet_tpu.recipes.gan.{name}") is getattr(gan, name)
    # the serving modules (streaming, the checkpoint import) resolve in the port
    from spiking_fullsubnet_torch import streaming
    from spiking_fullsubnet_torch.runtime import convert
    assert registry.resolve("spiking_fullsubnet_tpu.runtime.convert.import_spiking_fullsubnet") \
        is convert.import_spiking_fullsubnet
    assert registry.resolve("spiking_fullsubnet_tpu.streaming.StreamingEnhancer") \
        is streaming.StreamingEnhancer
    assert registry.resolve("spiking_fullsubnet_tpu.models.fused_forward."
                            "spiking_fullsubnet_fused_forward") \
        is fused_forward.spiking_fullsubnet_fused_forward
    # the separation and dereverberation modules resolve in the port
    from spiking_fullsubnet_torch.data import ScpDataset, wsj0_mix
    from spiking_fullsubnet_torch.losses import pit
    from spiking_fullsubnet_torch.models import conv_tasnet
    from spiking_fullsubnet_torch.recipes import dereverb, separation
    for path, obj in [("models.conv_tasnet.build", conv_tasnet.build),
                      ("data.wsj0_mix.WSJ0MixDataset", wsj0_mix.WSJ0MixDataset),
                      ("data.ScpDataset", ScpDataset), ("losses.pit.pit_wrapper", pit.pit_wrapper),
                      ("recipes.separation.SeparationTrainer", separation.SeparationTrainer),
                      ("recipes.dereverb.DereverbTrainer", dereverb.DereverbTrainer)]:
        assert registry.resolve("spiking_fullsubnet_tpu." + path) is obj, path
    # the remaining models and DNSMOS resolve in the port
    from spiking_fullsubnet_torch.metrics import dnsmos
    from spiking_fullsubnet_torch.models import fullsubnet, sdnn
    from spiking_fullsubnet_torch.recipes import sdnn_delays
    for path, obj in [("models.sdnn.build", sdnn.build),
                      ("models.fullsubnet.build", fullsubnet.build),
                      ("metrics.dnsmos.DNSMOS", dnsmos.DNSMOS), ("metrics.DNSMOS", dnsmos.DNSMOS),
                      ("metrics.dnsmos.pDNSMOS", dnsmos.pDNSMOS),
                      ("recipes.sdnn_delays.SdnnDelaysTrainer", sdnn_delays.SdnnDelaysTrainer)]:
        assert registry.resolve("spiking_fullsubnet_tpu." + path) is obj, path
    # data parallelism and the mesh of the band axis resolve in the port, and
    # so do the spectral module's layout switches
    from spiking_fullsubnet_torch.dsp import spectral
    from spiking_fullsubnet_torch.parallel import dist as pdist, mesh as pmesh
    for path, obj in [("parallel.dist.scale_lr", pdist.scale_lr),
                      ("parallel.gather_for_metrics", pdist.gather_for_metrics),
                      ("parallel.mesh.make_mesh", pmesh.make_mesh),
                      ("parallel.shard_batch", pmesh.shard_batch),
                      ("parallel.batch_sharding", pmesh.batch_sharding),
                      ("parallel.mesh.current_axis_size", pmesh.current_axis_size),
                      ("dsp.spectral.stft_complex_tmajor", spectral.stft_complex_tmajor),
                      ("dsp.spectral.istft_complex_tmajor", spectral.istft_complex_tmajor)]:
        assert registry.resolve("spiking_fullsubnet_tpu." + path) is obj, path
    # the rest of the package's surface resolves in the port
    from spiking_fullsubnet_torch.dsp import sslt
    from spiking_fullsubnet_torch.models import modules
    from spiking_fullsubnet_torch.native import wavio
    from spiking_fullsubnet_torch.nn import module_tracer
    from spiking_fullsubnet_torch.runtime import debug
    for path, obj in [("models.modules.tac_apply", modules.tac_apply),
                      ("dsp.sslt.cart2sph", sslt.cart2sph), ("dsp.cart2sph", sslt.cart2sph),
                      ("nn.module_tracer.ActivationTracer", module_tracer.ActivationTracer),
                      ("native.wavio.read_batch", wavio.read_batch),
                      ("runtime.clamp_inf_value", debug.clamp_inf_value)]:
        assert registry.resolve("spiking_fullsubnet_tpu." + path) is obj, path
    # the bench support resolves in the port
    from spiking_fullsubnet_torch.runtime import cache, roofline, timing
    for path, obj in [("runtime.timing.time_fn_per_iter", timing.time_fn_per_iter),
                      ("runtime.timing.checksum", timing.checksum),
                      ("runtime.roofline.roofline_report", roofline.roofline_report),
                      ("runtime.roofline.spiking_fullsubnet_cost",
                       roofline.spiking_fullsubnet_cost),
                      ("runtime.cache.enable_compilation_cache", cache.enable_compilation_cache)]:
        assert registry.resolve("spiking_fullsubnet_tpu." + path) is obj, path
    # the Pallas module's kernels are ops/gsu_kernels.py's, under other names
    for path in ("spiking_fullsubnet_tpu.ops.gsu_pallas.gsu_stack_eval_pallas",
                 "spiking_fullsubnet_torch.ops.gsu_pallas.gsu_layer_pallas"):
        with pytest.raises(ImportError, match="counterpart is spiking_fullsubnet_torch/ops/"
                                              "gsu_kernels.py"):
            registry.resolve(path)
    with pytest.raises(ImportError):
        registry.resolve("no_such_package_anywhere.thing")
    # every module has its port: a name the package lacks is unknown
    for path in ("spiking_fullsubnet_tpu.dsp.spectral.no_such_name",
                 "spiking_fullsubnet_tpu.no_such_module.thing"):
        with pytest.raises(ImportError):
            registry.resolve(path)
    with pytest.raises(NotImplementedError, match="not mapped"):
        registry.build_optimizer_factory("torch.optim.RMSprop", {"lr": 1e-3})


def test_trainer_state_round_trip_matches_jax(tmp_path):
    st, jst = TrainerState(), JaxTrainerState()
    assert st.state_dict() == jst.state_dict()
    assert TrainerState(save_max_score=False).best_score == np.inf
    for s in (st, jst):
        s.epochs_trained, s.steps_trained, s.patience = 7, 91, 2
        s.best_score, s.best_score_epoch = 12.625, 5
    assert st.state_dict() == jst.state_dict()
    st.save_json(tmp_path / "port.json")
    jst.save_json(tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    back = TrainerState()
    back.load_json(tmp_path / "jax.json")
    assert back.state_dict() == st.state_dict()


def _tree(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"fb": [torch.randn(3, 2, generator=g)], "w": torch.randn(4, generator=g)},
            "model_state": {"bn": torch.randn(2, generator=g)},
            "opt_state": {"state": {0: {"step": torch.tensor(3.0)}}, "param_groups": []}}


def test_checkpoints_rotate_and_resolve(tmp_path):
    mgr = CheckpointManager(tmp_path / "checkpoints", max_num_checkpoints=2)
    with pytest.raises(FileNotFoundError):
        mgr.find_latest()
    st = TrainerState()
    trees = {}
    for epoch in range(1, 5):
        st.epochs_trained = epoch
        trees[epoch] = _tree(epoch)
        mgr.save(epoch, trees[epoch], st, is_best_epoch=False)
        if epoch == 2:
            st.best_score = 3.5
            mgr.save(epoch, trees[epoch], st, is_best_epoch=True)
    names = sorted(p.name for p in (tmp_path / "checkpoints").iterdir())
    assert names == ["best", "epoch_0003", "epoch_0004"]
    assert mgr.find_latest().name == "epoch_0004"
    assert mgr.resolve("latest") == mgr.find_latest()
    assert mgr.resolve("best") == tmp_path / "checkpoints" / "best"
    assert mgr.resolve(str(tmp_path / "checkpoints" / "epoch_0003")).name == "epoch_0003"
    with pytest.raises(FileNotFoundError):
        mgr.resolve(str(tmp_path / "checkpoints" / "epoch_0001"))

    back = TrainerState()
    tree = mgr.load("best", back)
    assert back.epochs_trained == 2 and back.best_score == 3.5
    assert torch.equal(tree["params"]["fb"][0], trees[2]["params"]["fb"][0])
    assert torch.equal(tree["model_state"]["bn"], trees[2]["model_state"]["bn"])
    assert tree["opt_state"]["state"][0]["step"].item() == 3.0
    w = mgr.load_weights("latest")
    assert set(w) == {"params", "model_state"}
    assert torch.equal(w["params"]["w"], trees[4]["params"]["w"])
    latest = TrainerState()
    mgr.load_trainer_state("latest", latest)
    assert latest.epochs_trained == 4


def test_tensorboard_falls_back_to_jsonl_and_logging_writes_the_run_log(tmp_path, monkeypatch):
    import json
    import logging
    import sys

    from spiking_fullsubnet_torch.runtime.logging_ import TensorboardLogger, init_logging_logger

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    tb = TensorboardLogger(str(tmp_path / "tb_log"))
    assert tb.writer is None
    tb.add_scalar("Train_Step/norm", torch.tensor(2.5), 3)
    tb.log_config({"meta": {"seed": 1}})
    tb.close()
    rows = [json.loads(line) for line in (tmp_path / "tb_log" / "scalars.jsonl").read_text()
            .splitlines()]
    assert rows == [{"tag": "Train_Step/norm", "value": 2.5, "step": 3}]

    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        init_logging_logger({"meta": {"save_dir": str(tmp_path), "exp_id": "run"}})
        logging.getLogger("spiking_fullsubnet_torch.test").info("hello from the run")
        for h in root.handlers:
            h.flush()
        (log,) = (tmp_path / "run").glob("run_*.log")
        assert "hello from the run" in log.read_text()
        assert len(root.handlers) == 2
    finally:
        for h in root.handlers:
            h.close()
        root.handlers, _ = saved
        root.setLevel(saved[1])
