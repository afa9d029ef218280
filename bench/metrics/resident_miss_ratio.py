"""resident_miss_ratio: the router's ``RouteStats.resident_misses`` over its
``prefills``, counted over the window's requests: the share of the
window's prefills whose document the designated node (``label % n_nodes``)
already held, each a prefill that a probe of that node would have saved
(the paper's cost of false negatives: the router passed the node over,
mostly on a stale negative indication).

The counter is the program's own.  The window's counters that the harness
hands a reader (``Server.stats``) do not hold it, so the reader counts it
with the program's router replaying the run's stream: set-up's requests,
then as many as the window routed.  The router's decisions depend on the
stream alone (the traffic file's ``trace_seed`` and ``router_seed``), which
``route_mismatch`` checks request by request, and the replay is read only
where every window counter the harness handed over equals the replay's.
A program without the counter reads nothing."""
from bench import streams


def read(run):
    from repro_torch.serving import ClusterConfig, PrefixServeCluster
    tr = run.traffic
    cluster = PrefixServeCluster(ClusterConfig(**tr["cluster"]),
                                 seed=tr["stream"]["router_seed"])
    st = cluster.stats
    if not hasattr(st, "resident_misses"):
        return None
    labels = streams.stream(tr)
    n0 = tr["warm"]["requests"]
    for label in labels[:n0]:
        cluster.request(int(label))
    base = {k: getattr(st, k) for k in (*run.stats, "resident_misses")}
    for label in labels[n0:n0 + run.stats["requests"]]:
        cluster.request(int(label))
    if any(getattr(st, k) - base[k] != v for k, v in run.stats.items()):
        return None
    prefills = run.stats["prefills"]
    return (st.resident_misses - base["resident_misses"]) / prefills \
        if prefills else None
