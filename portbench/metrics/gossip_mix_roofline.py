"""``gossip_mix``'s share of its roofline: the frozen count of each window
(``portbench.work.gossip_mix`` at the cell's n, D and R) over the device
time of the gossip_mix kernels that window launched, in percent."""

from portbench import work


def is_kernel(name: str) -> bool:
    return "gossip_mix_" in name and "quantized_gossip_mix" not in name


def read(ctx):
    t, c = ctx.trace, ctx.cell
    if not t:
        return None
    times = [sum(d for name, d in win if is_kernel(name))
             for win in t["mix_windows"]]
    times = [s for s in times if s > 0]
    if not times:
        return None
    least = work.least_seconds(work.gossip_mix(c["n"], c["D"], c["R"],
                                               c["x_bytes"]))
    return 100.0 * least * len(times) / (sum(times) / 1e6)
