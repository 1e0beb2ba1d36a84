"""The collectives' share of the memory roofline, in %: the least time
their bytes need at the card's published bandwidth (every rank's input
read once and its output written once) over the device's busy time in
the same window."""


def read(ctx):
    bw = ctx["hbm_bytes_per_s"]
    if not bw or not ctx["busy_s"] or not ctx["least_bytes"]:
        return None
    return 100.0 * ctx["least_bytes"] / bw / ctx["busy_s"]
