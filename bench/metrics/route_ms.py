"""route_ms: the router's host time a request (``serving.prefix_cache``:
``PrefixServeCluster.request`` less the prefill it calls on a miss), mean
over the window's untraced requests, in milliseconds."""


def read(run):
    reqs = run.requests
    if not reqs:
        return None
    return 1e3 * sum(r.route_s for r in reqs) / len(reqs)
