"""The step's model FLOPs over the device's busy time, as a share of
the card's published peak, in %: the whole step's share of the peak
with the device's idle time left out."""


def read(ctx):
    if not ctx.get("peak_flops") or not ctx["busy_s"] or not ctx.get(
            "model_flops"):
        return None
    return 100.0 * ctx["model_flops"] / ctx["busy_s"] / ctx["peak_flops"]
