"""The model library (counterpart of ``spiking_fullsubnet_tpu/models``;
reference layer 2, audiozen/models/). The names the JAX package's
``models/__init__.py`` re-exports, resolved at first use (``_exports.py``)."""

from .._exports import lazy_exports, table_of

_NAMES = table_of({
    "sequence_model": ("SequenceModelConfig", "sequence_model_init", "sequence_model_apply",
                       "subband_sequence_model_apply"),
    "spiking_fullsubnet": ("SpikingFullSubNetConfig", "spiking_fullsubnet_init",
                           "spiking_fullsubnet_apply", "separator_config"),
    "cirm_models": ("CirmModelConfig", "cirm_model_init", "cirm_model_apply"),
    "fullsubnet": ("FullSubNetConfig", "fullsubnet_init", "fullsubnet_apply"),
    "conv_tasnet": ("ConvTasNetConfig", "conv_tasnet_init", "conv_tasnet_apply",
                    "conv_tasnet_base"),
    "discriminator": ("discriminator_init", "discriminator_apply"),
    "rnn_sequence_model": ("RnnSequenceModelConfig", "rnn_sequence_model_init",
                           "rnn_sequence_model_apply"),
})
__all__ = sorted(_NAMES)
__getattr__, __dir__ = lazy_exports(__name__, _NAMES)
