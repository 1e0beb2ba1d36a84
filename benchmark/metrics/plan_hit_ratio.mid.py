"""Share of dispatches that fired a cached plan: the
``coll_plan_cache_hits`` aggregate's sum over its count in the window."""


def read(ctx):
    agg = ctx["pvars"].get("coll_plan_cache_hits")
    if not agg or not agg.get("count"):
        return None
    return agg["sum"] / agg["count"]
