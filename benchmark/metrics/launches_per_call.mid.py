"""Device operations (kernels, copies, sets) a collective, from the
profiler's trace."""

from metrics import collectives


def read(ctx):
    n = collectives(ctx)
    launches = sum(c for _, c in ctx["ops"].values())
    if not n or not launches:
        return None
    return launches / n
