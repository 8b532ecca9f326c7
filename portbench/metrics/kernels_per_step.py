"""Device kernels launched inside the harness's step range, per profiled
step: the host's dispatch work, which a fused or captured step lowers."""


def read(ctx):
    t = ctx.trace
    return t["kernels"] / t["steps"] if t and t["kernels"] else None
