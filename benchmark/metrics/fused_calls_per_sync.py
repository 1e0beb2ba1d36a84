"""Collectives the program issued a gradient sync: the
``coll_invocations`` delta over the syncs (fusion packs the small
gradients into fewer calls)."""

from metrics import collectives


def read(ctx):
    n = collectives(ctx)
    if not n or not ctx["steps"]:
        return None
    return n / ctx["steps"]
