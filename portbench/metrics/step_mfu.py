"""The whole step's share of the card's peak: the model FLOPs of the profiled
steps (forward and backward of every node's micro-batches, the causal
attention's masked half not counted, nothing recomputed) over the traced
window's seconds, which span those steps from the first launch to the last
result, and the peak of the configuration's precision, in percent."""

from portbench import work


def read(ctx):
    t = ctx.trace
    if not t or not t["steps"] or not ctx.cell.get("model_flops_per_step"):
        return None
    rate = ctx.cell["model_flops_per_step"] * t["steps"] / t["window_s"]
    return 100.0 * rate / work.PEAK_FLOPS[ctx.cell["precision"]]
