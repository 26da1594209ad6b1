"""idle_share.serve: the share of the traced serving window in which no
operation ran on the device, in %."""


def read(ctx):
    if ctx["mode"] != "serve" or ctx["busy_s"] <= 0 or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
