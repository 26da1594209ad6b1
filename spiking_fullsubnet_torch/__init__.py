"""PyTorch + CUDA port of spiking_fullsubnet_tpu.

Module names mirror the JAX package (``spiking_fullsubnet_tpu``) so each
counterpart is easy to find. The port imports neither JAX nor the JAX
package. Its entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the hand-written Hopper kernels live in ``csrc/`` and are
built with nvcc at first use (``ops/gsu_kernels.py``).

Covered so far, with weights from the JAX ``.npz`` files or a seeded init:
- the layered forward (``scan_mode="layered"``, the default, and what
  ``"auto"`` sends there; every layer's spikes collected) with every GSU
  stack on kernel F, and the cIRM-GSN model (``models/cirm_models.py``) on
  the same kernel;
- the layered training step of both (``recipes/denoise.train_step``: the
  denoise loss of ``losses/losses.py``, backward, global-norm clipping and
  AdamW) with every GSU layer on kernels D (forward, batch-statistics BN)
  and E (reverse-time backward);
- serving through ``scan_mode="auto"`` with ``collect_layer_outputs=False``:
  the two-launch path (offline laplace norm, no pre-LayerNorm: the shipped
  zoo checkpoints; kernels A and B) and the whole-model monolith
  (pre-LayerNorm as in the flagship preset, the cumulative laplace norm, no
  norm; kernel C);
- the recipe trainer: ``python -m spiking_fullsubnet_torch.runtime.cli -C
  <toml> -M train|validate|test|predict|finetune`` on the repo's recipe
  TOMLs (``runtime/``, ``data/``, ``metrics/``,
  ``recipes/denoise.DenoiseTrainer``).
See ROADMAP.md for the rest.
"""
