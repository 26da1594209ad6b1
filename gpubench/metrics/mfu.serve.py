"""mfu.serve: the model's FLOPs (``work.model_flops_per_audio_second``, a
frozen copy of the program's roofline arithmetic) times the traced window's
audio-seconds per second, over the peak of the precision the configuration
serves in (bf16: 989 TFLOP/s), in %."""


def read(ctx):
    w = ctx["work"]
    if ctx["mode"] != "serve" or ctx["audio_s_per_s"] <= 0:
        return None
    prec = ctx["config"]["serve"].get("compute_dtype") or "float32"
    flops = w.model_flops_per_audio_second(ctx["geom"], ctx["traffic"]["sample_rate"])
    return 100.0 * flops * ctx["audio_s_per_s"] / w.PEAKS[prec]
