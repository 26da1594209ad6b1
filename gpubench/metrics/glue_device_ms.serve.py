"""glue_device_ms.serve: device milliseconds a forward in kernels other
than the port's own CUDA kernels (the stream formulation's STFT, norms,
hoisted products, packing and iSTFT as PyTorch ops), from the profiler's
device rows."""

PORT_KERNELS = ("monolith_kernel", "stack_kernel", "sections_kernel")


def read(ctx):
    if ctx["mode"] != "serve" or not ctx["kernels"] or ctx["units"] == 0:
        return None
    total = sum(s for _, s, _ in ctx["kernels"])
    port = sum(s for n, s, _ in ctx["kernels"] if any(p in n for p in PORT_KERNELS))
    return 1e3 * (total - port) / ctx["units"]
