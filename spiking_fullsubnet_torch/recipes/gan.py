"""The MetricGAN trainers: one discriminator, two (SIG and BAK), and the
generator alone (counterpart of ``spiking_fullsubnet_tpu/recipes/gan.py``).

Each update is a generator step, the quality targets on the host, then one
step of each discriminator (``gan.py:234-303``):
- generator: ``freq_mae + mag_mae + 0.001 (100 - SI-SNR)`` plus, for each
  discriminator, ``weight * mse(D(clean_mag, enh_mag), 1)`` with the
  discriminator in eval; gradients reach the generator only, which takes
  the base trainer's update (global norm before the clip, the clip, the
  rate of this update, AdamW);
- targets: each utterance's DNSMOS score of the target key, ``(score -
  1) / 4``, where ``onnxruntime`` imports; else the JAX package's fallback,
  ``clip((SI-SDR + 10) / 40, 0, 1)``;
- discriminator: ``mse(D(clean, clean), 1) + mse(D(clean, enh), target)``
  in training, the second pass from the ``u`` and ``v`` the first left;
  AdamW with optax's defaults (weight decay 1e-4), the rate from its own
  schedule; ``u`` and ``v`` are buffers outside the optimizer and take the
  second pass's values after the step (the JAX package runs optax over
  them and then overwrites them, ``gan.py:202-210``: the same values).
Without a discriminator ``GanDenoiseTrainer`` is the plain denoise loop.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..dsp.spectral import stft_complex
from ..losses.losses import freq_mae, mag_mae, mse_loss, si_snr
from ..metrics import si_sdr_value
from ..models.discriminator import build as build_discriminator
from ..models.discriminator import discriminator_apply, discriminator_weights, spectral_layers
from ..nn.core import tree_map
from ..runtime.optimization import (create_warmup_schedule, get_exponential_schedule,
                                    get_warmup_steps)
from ..runtime.trainer import optimizer_update
from .denoise import DenoiseTrainer


def build_discriminator_bundles(config, seed, device=None) -> Dict[str, Any]:
    """``{"discriminators": {name: bundle}}`` for every ``[model_d*]``
    section of the TOML (``gan.py:46-59``): ``[model_d]`` is ``d``,
    ``[model_d_sig]`` ``d_sig``; the i-th drawn from ``seed + 1 + i``.
    Empty without such a section."""
    bundles = {}
    for i, key in enumerate(k for k in config if k == "model_d" or k.startswith("model_d_")):
        args = config[key].get("args") or {}
        name = "d" if key == "model_d" else key[len("model_"):]
        bundles[name] = build_discriminator(seed=seed + 1 + i, device=device, **args)
    return {"discriminators": bundles} if bundles else {}


class GanDenoiseTrainer(DenoiseTrainer):
    """Denoise trainer with 0..N MetricGAN discriminators.

    ``disc_specs``: (name, DNSMOS target key, generator-loss weight) each."""

    disc_specs = (("d", "OVRL", 0.05),)
    include_sdr_loss = True

    def __init__(self, *args, discriminators=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.disc_params = {name: b["params"] for name, b in (discriminators or {}).items()}
        if self.disc_params:
            missing = [s[0] for s in self.disc_specs if s[0] not in self.disc_params]
            if missing:
                raise ValueError(f"disc_specs expect discriminators {missing}; got "
                                 f"{list(self.disc_params)}")
            # the JAX GAN loop makes one update a batch whatever the TOML says
            self.gradient_accumulation_steps = 1
        # AdamW with optax.adamw's defaults; the rate is set before each step
        self.disc_optimizers = {
            name: torch.optim.AdamW([w.requires_grad_(True) for w in discriminator_weights(p)],
                                    lr=self.base_lr, betas=(0.9, 0.999), eps=1e-8,
                                    weight_decay=1e-4)
            for name, p in self.disc_params.items()}
        self.disc_schedules = {}
        acoustics = self.config.get("acoustics", {})
        self.stft_args = tuple(acoustics.get(k, d) for k, d in
                               (("n_fft", 512), ("hop_length", 128), ("win_length", 512)))

    @property
    def gan_enabled(self) -> bool:
        return bool(self.disc_params)

    # ---- checkpoints hold every discriminator and its optimizer state ----
    def _train_tree(self):
        tree = super()._train_tree()
        if self.gan_enabled:
            tree["disc_params"] = self.disc_params
            tree["disc_opt_states"] = {n: o.state_dict()
                                       for n, o in self.disc_optimizers.items()}
        return tree

    def _restore(self, tree):
        super()._restore(tree)
        if not self.gan_enabled:
            return
        for name, params in self.disc_params.items():
            saved = tree["disc_params"][name]
            with torch.no_grad():
                for w, s in zip(discriminator_weights(params), discriminator_weights(saved)):
                    w.copy_(s)
            for layer, s in zip(spectral_layers(params), spectral_layers(saved)):
                layer.update(u=s["u"], v=s["v"])
            self.disc_optimizers[name].load_state_dict(tree["disc_opt_states"][name])

    # ---- learning rates ----
    @property
    def whole_epochs(self) -> bool:
        """With discriminators, ``max_steps`` rounds up to whole epochs, as
        in the JAX package's GAN loop."""
        return self.gan_enabled

    def _disc_schedule(self, name: str, max_steps: int, steps_per_epoch: int):
        """``[optimizer_<name>] lr`` and ``[lr_scheduler_<name>] gamma``
        (``gan.py:119-131``): torch's ExponentialLR, a step an epoch, when
        gamma is set, else the warm-up schedule."""
        opt_cfg = self.config.get(f"optimizer_{name}", {}).get("args", {}) or {}
        lr = float(opt_cfg.get("lr", self.base_lr))
        gamma = (self.config.get(f"lr_scheduler_{name}", {}).get("args", {}) or {}).get("gamma")
        if gamma is not None and steps_per_epoch:
            return get_exponential_schedule(lr, float(gamma), steps_per_epoch)
        num_warmup = get_warmup_steps(self.warmup_steps, max_steps, self.warmup_ratio)
        return create_warmup_schedule(self.scheduler_name, lr, max_steps, num_warmup)

    def _build_schedules(self, max_steps: int, steps_per_epoch: int):
        """``[lr_scheduler_g] gamma`` selects ExponentialLR for the generator
        (``gan.py:133-140``); each discriminator's schedule beside it."""
        gamma = (self.config.get("lr_scheduler_g", {}).get("args", {}) or {}).get("gamma")
        if self.gan_enabled and gamma is not None and steps_per_epoch:
            self.lr_schedule = get_exponential_schedule(self.base_lr, float(gamma),
                                                        steps_per_epoch)
        else:
            super()._build_schedules(max_steps, steps_per_epoch)
        self.disc_schedules = {n: self._disc_schedule(n, max_steps, steps_per_epoch)
                               for n in self.disc_params}

    # ---- the steps ----
    def generator_step(self, noisy: torch.Tensor, clean: torch.Tensor, lr: float):
        """The generator's forward, loss, backward and update at rate ``lr``
        (``gan.py:161-189``). Returns (loss dict, the global norm before the
        clip, the enhanced audio, its magnitude, the clean magnitude), the
        last three detached."""
        clean_mag = stft_complex(clean, *self.stft_args).abs()
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model_apply(self.model_config, self.params, self.model_state, noisy,
                               train=True)
        enh_y, enh_mag = out["enhanced_y"], out["enhanced_mag"]
        loss_freq, loss_mag = freq_mae(enh_y, clean), mag_mae(enh_y, clean)
        loss = loss_freq + loss_mag
        aux = {"loss_freq_mae": loss_freq, "loss_mag_mae": loss_mag}
        if self.include_sdr_loss:
            aux["loss_sdr"] = 0.001 * (100.0 - si_snr(enh_y, clean))
            loss = loss + aux["loss_sdr"]
        for name, _, weight in self.disc_specs:
            frozen = tree_map(torch.Tensor.detach, self.disc_params[name])
            pred_fake, _ = discriminator_apply(frozen, clean_mag, enh_mag, train=False)
            aux[f"loss_g_fake_{name}"] = weight * mse_loss(pred_fake, torch.ones_like(pred_fake))
            loss = loss + aux[f"loss_g_fake_{name}"]
        aux["loss_g"] = loss
        loss.backward()
        self.model_state = out["state"]
        grad_norm = optimizer_update(self.optimizer, self.max_grad_norm, lr)
        self.optimizer.zero_grad(set_to_none=True)
        return ({k: v.detach() for k, v in aux.items()}, grad_norm, enh_y.detach(),
                enh_mag.detach(), clean_mag)

    def discriminator_step(self, name: str, clean_mag: torch.Tensor, enh_mag: torch.Tensor,
                           target: torch.Tensor, lr: float) -> Dict[str, torch.Tensor]:
        """One step of discriminator ``name`` at rate ``lr`` (``gan.py:191-213``);
        returns its detached losses."""
        params, opt = self.disc_params[name], self.disc_optimizers[name]
        opt.zero_grad(set_to_none=True)
        pred_real, after = discriminator_apply(params, clean_mag, clean_mag, train=True)
        pred_fake, after = discriminator_apply(after, clean_mag, enh_mag, train=True)
        loss_real = mse_loss(pred_real, torch.ones_like(pred_real))
        loss_fake = mse_loss(pred_fake, target)
        (loss_real + loss_fake).backward()
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        opt.zero_grad(set_to_none=True)
        for layer, new in zip(spectral_layers(params), spectral_layers(after)):
            layer.update(u=new["u"], v=new["v"])
        return {"loss_d": (loss_real + loss_fake).detach(), "loss_d_real": loss_real.detach(),
                "loss_d_fake": loss_fake.detach()}

    def batch_mos(self, enh: np.ndarray, clean: np.ndarray, targets) -> Dict[str, np.ndarray]:
        """Each target key's column ``[B, 1]`` float32 (``gan.py:216-232``):
        DNSMOS's score (P.835, no P.808) mapped to ``(score - 1) / 4``; without
        DNSMOS, the utterance's SI-SDR clamped into [0, 1]."""
        cols = {t: [] for t in targets}
        for e, c in zip(enh, clean):
            if self.dns_mos is not None:
                scores = self.dns_mos(e, return_p808=False)
                for t in targets:
                    cols[t].append((scores[t] - 1.0) / 4.0)
            else:
                v = float(np.clip((si_sdr_value(e, c) + 10.0) / 40.0, 0.0, 1.0))
                for t in targets:
                    cols[t].append(v)
        return {t: np.asarray(v, np.float32)[:, None] for t, v in cols.items()}

    # ---- the update ----
    def _train_batch(self, batch, n: int):
        """One GAN update (``gan.py:234-303``): the generator step, the
        targets on the host, then each discriminator's step in ``disc_specs``
        order, all at update count ``n``."""
        if not self.gan_enabled:
            return super()._train_batch(batch, n)
        lr = self.lr_schedule(n)
        aux, grad_norm, enh_y, enh_mag, clean_mag = self.generator_step(
            self.to_device(batch[0]), self.to_device(batch[1]), lr)
        mos = self.batch_mos(enh_y.float().cpu().numpy(), np.asarray(batch[1]),
                             [s[1] for s in self.disc_specs])
        for name, target, _ in self.disc_specs:
            aux_d = self.discriminator_step(name, clean_mag, enh_mag,
                                            self.to_device(mos[target]).to(enh_mag.dtype),
                                            self.disc_schedules[name](n))
            aux.update({f"{k}_{name}": v for k, v in aux_d.items()})
        return aux, (grad_norm, lr)


class DualGanDenoiseTrainer(GanDenoiseTrainer):
    """Two discriminators (freeze-phase trainer_dualGAN.py:50-110): D_sig
    regresses the SIG target (generator weight 1.0), D_bak the BAK target
    (0.5)."""

    disc_specs = (("d_sig", "SIG", 1.0), ("d_bak", "BAK", 0.5))


class OnlyGenTrainer(DenoiseTrainer):
    """The generator alone (freeze-phase trainer_onlyGen.py:41-65): loss =
    freq_mae + mag_mae, no SI-SNR and no adversarial term."""

    def training_step(self, noisy: torch.Tensor, clean: torch.Tensor):
        out = self.model_apply(self.model_config, self.params, self.model_state, noisy,
                               train=True)
        enh = out["enhanced_y"]
        loss_freq_mae, loss_mag_mae = freq_mae(enh, clean), mag_mae(enh, clean)
        loss = loss_freq_mae + loss_mag_mae
        loss.backward()
        return ({"loss_g": loss.detach(), "loss_freq_mae": loss_freq_mae.detach(),
                 "loss_mag_mae": loss_mag_mae.detach()}, out["state"])
