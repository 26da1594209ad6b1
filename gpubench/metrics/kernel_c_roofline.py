"""kernel_c_roofline: the least time of kernel C's work in the traced window
(``work.kernel_c`` at each forward's batch shape: the whole model's
products, every GSU cell and the deep filter, audio in and out and the
weights once) over its device time there (profiler rows named
``monolith_kernel``), in %."""

PATTERNS = ("monolith_kernel",)


def read(ctx):
    w = ctx["work"]
    secs = sum(s for n, s, _ in ctx["kernels"] if any(p in n for p in PATTERNS))
    if ctx["mode"] != "serve" or secs <= 0 or not ctx["shapes"]:
        return None
    prec = ctx["config"]["serve"].get("compute_dtype") or "float32"
    io = 2 if prec == "bfloat16" else 4
    least = sum(w.least_time(w.kernel_c(ctx["geom"], B, n, io), prec) for B, n in ctx["shapes"])
    return 100.0 * least / secs
