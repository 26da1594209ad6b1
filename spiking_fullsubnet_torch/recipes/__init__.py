"""Reusable recipe trainer bases, denoise, dereverb, separation and the
MetricGAN trainers (counterpart of ``spiking_fullsubnet_tpu/recipes``). The
names the JAX package's ``recipes/__init__.py`` re-exports, resolved at
first use (``_exports.py``)."""

from .._exports import lazy_exports, table_of

_NAMES = table_of({
    "denoise": ("DenoiseTrainer",),
    "separation": ("SeparationTrainer",),
    "dereverb": ("DereverbTrainer",),
    "gan": ("DualGanDenoiseTrainer", "GanDenoiseTrainer", "OnlyGenTrainer",
            "build_discriminator_bundles"),
})
__all__ = sorted(_NAMES)
__getattr__, __dir__ = lazy_exports(__name__, _NAMES)
