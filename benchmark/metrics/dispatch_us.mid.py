"""Python time on the collective dispatch path a call, in us: the
``coll_orchestration_seconds`` delta over the ``coll_invocations``
delta (``coll/driver.py``: dispatch entry to the body's launch)."""

from metrics import collectives


def read(ctx):
    n = collectives(ctx)
    t = ctx["pvars"].get("coll_orchestration_seconds")
    if not n or t is None:
        return None
    return t / n * 1e6
