"""The port's trace-file loader (``repro_torch.cachesim.tracefiles``) on
the CPU, against the JAX reference's.

  * the committed sample logs (``tests/data/sample_recency.log.gz``,
    ``sample_zipf.csv.gz``) parse to arrays equal to the reference's
    ``load_trace_file``, with their ``TraceInfo``; the port's parse cache
    lands under its own file name, never the reference's, and neither
    package reads the other's cache;
  * every log shape (line-per-key / CSV, plain or gzipped) parses equal to
    the reference, one-shot and chunked (``iter_trace_chunks``,
    ``stream_trace_info``), with subsampling;
  * ``get_trace`` resolves ``file:<path>`` and registered aliases;
  * ``chunk_size`` is rejected at the call, by name;
  * the port's writer (``repro_torch.tools.make_trace_file``) writes the
    reference tool's bytes for every shape, plain and gzipped, and its
    ``--samples`` the committed sample logs byte for byte.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.cachesim.tracefiles as ref_tf
import repro_torch.cachesim.tracefiles as tf
from repro_torch.cachesim import get_scenario, get_trace
from repro_torch.tools.make_trace_file import write_trace_file

ROOT = Path(__file__).resolve().parent.parent

DATA = Path(__file__).parent / "data"
SAMPLES = {"sample_recency": (DATA / "sample_recency.log.gz", {}),
           "sample_zipf": (DATA / "sample_zipf.csv.gz",
                           {"key_column": "key"})}


@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_sample_logs_parse_equal_to_reference(name, tmp_path, monkeypatch):
    path, kw = SAMPLES[name]
    got, info = tf.load_trace_file(path, cache_dir=tmp_path, with_info=True,
                                   **kw)
    want, ref_info = ref_tf.load_trace_file(path, cache_dir=tmp_path,
                                            with_info=True, **kw)
    assert got.dtype == np.int64 and got.tobytes() == want.tobytes()
    assert info.to_dict() == ref_info.to_dict()
    assert info.n_requests == 60_000
    files = sorted(p.name for p in tmp_path.glob("*.npz"))
    assert len(files) == 2          # one cache per package, names differ
    # the warm load comes from the port's own cache, not a re-parse
    monkeypatch.setattr(tf, "parse_trace_file",
                        lambda *a, **k: pytest.fail("re-parsed"))
    again = tf.load_trace_file(path, cache_dir=tmp_path, head=5_000, **kw)
    assert again.tobytes() == want[:5_000].tobytes()
    # the port's scenario registry binds the same files
    assert tf.resolve(name)["path"] == str(path)
    assert get_trace(name, 5_000).tobytes() == want[:5_000].tobytes()


def test_port_never_reads_the_reference_cache(tmp_path, monkeypatch):
    """A cache the reference wrote for a log is not the port's hit: the
    port parses with its own parser and writes its own cache file."""
    log = write_trace_file(get_trace("gradle", 3_000, seed=1),
                           tmp_path / "t.log", "keys")
    want = ref_tf.load_trace_file(log)
    [ref_cache] = tmp_path.glob("t.log.*.npz")
    calls = []
    parse = tf.parse_trace_file

    def counted(*a, **k):
        calls.append(1)
        return parse(*a, **k)

    monkeypatch.setattr(tf, "parse_trace_file", counted)
    got = tf.load_trace_file(log)
    assert calls == [1] and got.tobytes() == want.tobytes()
    caches = set(tmp_path.glob("t.log.*.npz"))
    assert len(caches) == 2 and ref_cache in caches
    port_cache = (caches - {ref_cache}).pop()
    with np.load(port_cache) as z:
        assert str(z["parse_key"]).startswith(tf.PARSE_TAG + ":")
    tf.load_trace_file(log)
    assert calls == [1]             # now the port's own cache hits


@pytest.fixture()
def trace():
    return get_trace("scarab", 4_000, seed=5)


@pytest.mark.parametrize("fmt", ("keys", "csv"))
@pytest.mark.parametrize("compress", (False, True))
def test_log_shapes_parse_equal_to_reference(tmp_path, trace, fmt,
                                             compress):
    suffix = (".csv" if fmt == "csv" else ".log") + (".gz" if compress else "")
    p = write_trace_file(trace, tmp_path / f"t{suffix}", fmt,
                         compress=compress)
    kw = {"key_column": "key"} if fmt == "csv" else {}
    got = tf.load_trace_file(p, cache=False, **kw)
    assert got.tobytes() == \
        ref_tf.load_trace_file(p, cache=False, **kw).tobytes()
    assert got.tobytes() == tf.dense_remap(trace).tobytes()
    chunks = list(tf.iter_trace_chunks(p, chunk_size=777, **kw))
    assert np.concatenate(chunks).tobytes() == got.tobytes()
    for head, stride in ((None, 1), (1_000, 3)):
        sub = tf.load_trace_file(p, cache=False, head=head, stride=stride,
                                 **kw)
        assert sub.tobytes() == ref_tf.load_trace_file(
            p, cache=False, head=head, stride=stride, **kw).tobytes()
        assert tf.stream_trace_info(p, head=head, stride=stride,
                                    chunk_size=500, **kw) == \
            tf.load_trace_file(p, cache=False, head=head, stride=stride,
                               with_info=True, **kw)[1]


def test_trace_info_and_dense_remap_equal_reference(trace):
    assert tf.trace_info(trace).to_dict() == \
        ref_tf.trace_info(trace).to_dict()
    keys = ["b", "a", "b", "c", "a"]
    assert tf.dense_remap(keys).tolist() == [0, 1, 0, 2, 1]
    assert tf.dense_remap(trace).tobytes() == \
        ref_tf.dense_remap(trace).tobytes()


def test_get_trace_resolves_files_and_aliases(tmp_path, trace, monkeypatch):
    monkeypatch.setattr(tf, "TRACE_FILES", dict(tf.TRACE_FILES))
    p = write_trace_file(trace, tmp_path / "alias.log", "keys")
    tf.register_trace_file("tmp_alias", p)
    tf.register_trace_file("tmp_alias", p)        # identical rebind: no-op
    got = get_trace("tmp_alias", 500, seed=3)     # seed accepted, ignored
    assert got.tobytes() == tf.dense_remap(trace)[:500].tobytes()
    assert get_trace(f"file:{p}", 500).tobytes() == got.tobytes()
    with pytest.raises(ValueError, match="already bound"):
        tf.register_trace_file("tmp_alias", tmp_path / "other.log")
    with pytest.raises(ValueError, match="shadows"):
        tf.register_trace_file("wiki", p)
    with pytest.raises(KeyError, match="registered trace files"):
        get_trace("no_such_trace", 100)


def test_trace_file_smoke_reads_the_samples():
    sc = get_scenario("trace_file_smoke")
    assert all(tf.is_trace_file(t) for t in sc.traces)
    infos = sc.file_trace_infos(sc.golden_n_requests)
    assert set(infos) == set(sc.traces)
    for d in infos.values():
        assert d["n_requests"] == sc.golden_n_requests
        assert d["n_requests_file"] == 60_000


@pytest.mark.parametrize("bad", (0, -3, 2.5, True, "64"))
def test_chunk_size_rejected_at_the_call(bad, tmp_path):
    from repro_torch.cachesim import SimConfig, Simulator, SystemTrace
    with pytest.raises(ValueError, match="chunk_size"):
        tf.iter_trace_chunks(tmp_path / "never_read.log", chunk_size=bad)
    with pytest.raises(ValueError, match="chunk_size"):
        SystemTrace.compute(Simulator(SimConfig(), "cpu"),
                            get_trace("gradle", 50, seed=0), chunk_size=bad)


def _reference_tool():
    """The reference's ``tools/make_trace_file.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "ref_make_trace_file", ROOT / "tools" / "make_trace_file.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fmt", ("keys", "csv"))
@pytest.mark.parametrize("compress", (False, True))
def test_writer_bytes_equal_reference_tool(tmp_path, trace, fmt, compress):
    # one file name in two directories: gzip's header holds the name
    ref = _reference_tool()
    got = write_trace_file(trace, tmp_path / "port" / "t", fmt,
                           compress=compress)
    want = ref.write_trace_file(trace, tmp_path / "ref" / "t", fmt,
                                compress=compress)
    assert got.read_bytes() == want.read_bytes()


def test_samples_cli_writes_the_committed_logs(tmp_path):
    """``python -m repro_torch.tools.make_trace_file --samples -o DIR``
    (no ``repro`` on the path) writes ``tests/data``'s files byte for
    byte."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.tools.make_trace_file", "--samples",
                        "-o", str(tmp_path)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    for name in ("sample_recency.log.gz", "sample_zipf.csv.gz"):
        assert (tmp_path / name).read_bytes() == (DATA / name).read_bytes()
