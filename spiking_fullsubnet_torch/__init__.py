"""PyTorch + CUDA port of spiking_fullsubnet_tpu.

Module names mirror the JAX package (``spiking_fullsubnet_tpu``) so each
counterpart is easy to find. The port imports neither JAX nor the JAX
package. Its entry points run on ``cuda`` unless the caller passes
``device="cpu"``; the hand-written Hopper kernels live in ``csrc/`` and are
built with nvcc at first use (``ops/gsu_kernels.py``).

Covered so far: eval enhancement through ``scan_mode="auto"`` with
``collect_layer_outputs=False``: the two-launch serving path (offline
laplace norm, no pre-LayerNorm: the shipped zoo checkpoints; kernels A and
B) and the whole-model monolith (pre-LayerNorm as in the flagship preset,
the cumulative laplace norm, no norm; kernel C), with weights from the JAX
``.npz`` files or a seeded init. See ROADMAP.md for the rest.
"""
