"""Device ms a step of the operations launched inside the program's
``obs_grad`` range: the oracle, every node's R micro-batches forward and
backward and the clip."""


def read(ctx):
    t = ctx.trace
    return t["grad_ms"] / t["steps"] if t and t["grad_ms"] else None
