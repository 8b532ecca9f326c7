"""Device ms a step of the operations launched inside the harness's step
range but outside the oracle and the mix: the rule's passes over the
(n, D) state (x − γh, h − g⁻, h + g)."""


def read(ctx):
    t = ctx.trace
    return t["rule_ms"] / t["steps"] if t and t["rule_ms"] else None
