"""prefill_ms: ``ServeEngine.prefill`` to a device sync, host clock, mean
over the window's untraced prefills, in milliseconds."""


def read(run):
    times = [r.prefill_s for r in run.requests if not r.hit]
    return 1e3 * sum(times) / len(times) if times else None
