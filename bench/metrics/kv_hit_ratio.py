"""kv_hit_ratio: the router's ``RouteStats.kv_hits`` over its
``requests``, counted over the window's requests."""


def read(run):
    n = run.stats["requests"]
    return run.stats["kv_hits"] / n if n else None
