"""decode_ms_per_tok: ``ServeEngine.decode`` time over the tokens it
returns, host clock, over the window's untraced requests, in
milliseconds."""


def read(run):
    toks = sum(len(r.tokens) for r in run.requests)
    return 1e3 * sum(r.decode_s for r in run.requests) / toks if toks \
        else None
