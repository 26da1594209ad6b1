"""Command-line tools of the port, each ``python -m
spiking_fullsubnet_torch.tools.<name> ... [--device cuda|cpu]`` and each
the counterpart of the root ``tools/<name>.py``: ``convert_checkpoint`` and
``export_serving`` (serving); ``bench_gsu_kernel`` and ``profile_trace``
(the kernels' bench and the profiler trace); ``reproduce_board``,
``build_model_zoo`` and ``metricsboard_writeout`` (the N-DNS board and the
model zoo); ``calculate_metrics``, ``dns_mos``, ``check_audio``,
``loudness_norm``, ``resampling``, ``misc_data``, ``noise_to_hdf5``,
``extract_speaker_embedding`` and ``validate_metric_backends`` (the data and
metric tools)."""
