"""kernel_b_roofline: the least time of kernel B's work in the traced window
(``work.kernel_b`` at each forward's batch shape: every section's GSU
stacks, their layer-0 input products, projections and deep filter) over its
device time there (profiler rows named ``sections_kernel``), in %."""

PATTERNS = ("sections_kernel",)


def read(ctx):
    w = ctx["work"]
    secs = sum(s for n, s, _ in ctx["kernels"] if any(p in n for p in PATTERNS))
    if ctx["mode"] != "serve" or secs <= 0 or not ctx["shapes"]:
        return None
    prec = ctx["config"]["serve"].get("compute_dtype") or "float32"
    io = 2 if prec == "bfloat16" else 4
    least = sum(w.least_time(w.kernel_b(ctx["geom"], B, n, io), prec) for B, n in ctx["shapes"])
    return 100.0 * least / secs
