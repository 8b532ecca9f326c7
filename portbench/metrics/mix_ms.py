"""Device ms a step of the operations launched inside the program's
``obs_mix`` ranges: the gossip windows of x and of the tracker."""


def read(ctx):
    t = ctx.trace
    return t["mix_ms"] / t["steps"] if t and t["mix_ms"] else None
