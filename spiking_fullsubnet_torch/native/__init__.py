"""Native (C++) host components of the port (counterpart of
``spiking_fullsubnet_tpu/native``): the WAV codec and threaded batch reader
of ``wavio.cpp``, built with the C++ compiler at first use and loaded
through ctypes (``wavio.py``)."""

from .wavio import (  # noqa: F401
    native_available,
    read_batch,
    wav_info,
    wav_read,
    wav_write,
)
