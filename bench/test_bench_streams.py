"""The traffic generator: the same seed gives the same requests and
documents; the stream is the traffic file's, the same for every seed."""
import json
from pathlib import Path

import numpy as np

from bench import streams

TRAFFIC = Path(__file__).resolve().parent / "traffic"


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def test_same_seed_same_stream_and_documents():
    tr = _mix("docqa")
    a, b = streams.stream(tr), streams.stream(tr)
    assert np.array_equal(a, b) and len(a) == tr["stream"]["requests"]
    d1 = streams.Documents(2**31 + 11, 32000, 64)
    d2 = streams.Documents(2**31 + 11, 32000, 64)
    for label in a[:50]:
        assert np.array_equal(d1(int(label)), d2(int(label)))


def test_the_stream_is_the_files_not_the_seeds():
    """Every seed routes the same stream (its tokens differ): the work a
    run serves does not change with the seed."""
    tr = _mix("docqa")
    want = streams.recency_trace(tr["stream"]["requests"], 0.15, 96, 1.2,
                                 tr["stream"]["trace_seed"])
    assert np.array_equal(streams.stream(tr), want)
    other = dict(tr, stream=dict(tr["stream"], trace_seed=1))
    assert not np.array_equal(streams.stream(other), want)


def test_documents_differ_by_seed_and_stay_in_vocab():
    one, two = streams.Documents(1, 256, 4096), streams.Documents(2, 256,
                                                                  4096)
    x, y = one(77), two(77)
    assert x.shape == (1, 4096) and x.dtype == np.int32
    assert not np.array_equal(x, y)
    assert x.min() >= 0 and x.max() < 256 and len(np.unique(x)) == 256


def test_recency_shape():
    ids = streams.recency_trace(20000, p_new=0.15, window=96, alpha=1.2,
                                seed=3)
    new = np.r_[True, ids[1:] > np.maximum.accumulate(ids)[:-1]]
    assert abs(new.mean() - 0.15) < 0.02
    # every repeat names an id seen in the last `window` requests or the
    # seeded history
    hist = list(range(1, 97))
    for x in ids[:3000]:
        assert x in hist[-96:] or x > max(hist)
        hist.append(int(x))


def test_frozen_copy_equals_the_program_generator():
    from repro_torch.cachesim.traces import recency_trace
    for seed in (0, 7):
        for p_new in (0.15, 1.0):
            want = recency_trace(3000, p_new=p_new, window=96, alpha=1.2,
                                 seed=seed)
            got = streams.recency_trace(3000, p_new, 96, 1.2, seed)
            assert np.array_equal(got, want)


def test_unshared_never_repeats():
    a = streams.stream(_mix("unshared"))
    assert len(np.unique(a)) == len(a)
