"""Share of the traced window in which no kernel, copy or set ran on the
device, in percent."""


def read(ctx):
    t = ctx.trace
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
