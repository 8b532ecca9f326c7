"""``quantized_gossip_mix``'s share of its roofline: the frozen count of each
compressed window (``portbench.work.quantized_gossip_mix`` at the cell's n,
D, R and dtypes) over the device time of the quantized_gossip_mix kernels
that window launched, in percent."""

from portbench import work


def read(ctx):
    t, c = ctx.trace, ctx.cell
    if not t or not c.get("compression"):
        return None
    times = [sum(d for name, d in win if "quantized_gossip_mix" in name)
             for win in t["mix_windows"]]
    times = [s for s in times if s > 0]
    if not times:
        return None
    least = work.least_seconds(work.quantized_gossip_mix(
        c["n"], c["D"], c["R"], c["x_bytes"], c["res_bytes"]))
    return 100.0 * least * len(times) / (sum(times) / 1e6)
