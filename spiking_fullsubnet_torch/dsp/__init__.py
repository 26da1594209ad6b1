"""DSP and acoustics primitives (counterpart of
``spiking_fullsubnet_tpu/dsp``; reference layer 1, audiozen/acoustics/).
The names the JAX package's ``dsp/__init__.py`` re-exports, resolved at
first use (``_exports.py``)."""

from .._exports import lazy_exports, table_of

_NAMES = table_of({
    "spectral": ("hann_window", "stft", "stft_complex", "istft", "istft_complex", "mag_phase",
                 "frame_signal", "num_frames", "make_stft_pair"),
    "mask": ("EPSILON", "build_complex_ideal_ratio_mask", "compress_cirm", "decompress_cirm",
             "complex_mul", "drop_band"),
    "feature_norm": ("offline_laplace_norm", "cumulative_laplace_norm", "offline_gaussian_norm",
                     "cumulative_layer_norm", "forgetting_norm", "hybrid_norm", "norm_wrapper"),
    "norms": ("compute_rms", "norm_amplitude", "is_clipped", "loudness_max_norm",
              "loudness_rms_norm", "normalize_segmental_rms", "active_rms", "sxr2gain",
              "tune_dB_FS", "activity_detector"),
    "io": ("load_wav", "save_wav", "load_audio", "subsample", "find_files"),
    "filterbank": ("bark_filter_bank", "hz_to_bark", "bark_to_hz"),
    "sslt": ("cart2sph", "sph2cart"),
})
__all__ = sorted(_NAMES)
__getattr__, __dir__ = lazy_exports(__name__, _NAMES)
