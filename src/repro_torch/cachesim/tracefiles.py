"""Real-trace ingestion: external request logs -> simulator request arrays
— the port of the JAX package's ``repro.cachesim.tracefiles`` (host NumPy,
as in the reference).

The paper's headline results (Figs. 3-7) are established on *measured*
traces — Wiki, Gradle, Scarab, F2 — and the journal version
(arXiv:2203.09119) plus the bandwidth-constrained follow-up
(arXiv:2104.01386) lean even harder on measured workloads.  This module
turns the request-log shapes that family of papers uses into the exact
``np.int64`` request-array contract the synthetic generators
(``repro_torch.cachesim.traces``) emit, so every scenario / sweep / golden
machinery runs unchanged on real logs.

Formats
-------
  * ``"keys"`` — one request key per line (the wiki-access-log shape
    after URL extraction).  Blank lines and ``#`` comments are skipped.
  * ``"csv"``  — delimited rows with a configurable key column (the
    CDN-log shape: timestamp, object id, size, ...).  ``key_column`` is
    either a 0-based index (headerless file) or a column NAME, in which
    case the first row is read as the header.

Both formats are gzip-transparent: a ``.gz`` suffix or the gzip magic
bytes switch decompression on automatically.  ``fmt=None`` infers from
the (possibly ``.gz``-stripped) suffix: ``.csv`` -> csv, else keys.

Ingestion pipeline
------------------
  1. parse the log into its raw key tokens (strings);
  2. densely remap keys to ``0..n_unique-1`` in FIRST-APPEARANCE order —
     deterministic, so the same file always yields the same array (the
     simulator hashes ids for placement, so dense ids lose nothing and
     keep memory bounded);
  3. cache the remapped array as ``<path>.<options-digest>.npz`` (one
     cache file per parse-option set), keyed by the source's SHA-256 —
     a million-request log parses once; the cache survives ``touch``
     (content hash, not mtime) and invalidates itself the moment the
     file's bytes change.  The cache lives next to the source by
     default; when ``REPRO_STORE`` is set it lives under the artifact
     store's ``traces/`` directory instead (fixing read-only source
     checkouts), with the next-to-source location kept as a read
     fallback so pre-existing caches still hit.  The options digest
     carries this package's tag (:data:`PARSE_TAG`), so the port never
     reads or overwrites a cache the JAX package wrote for the same log
     — each package's parser is exercised on its own;
  4. optionally subsample: ``stride`` keeps every stride-th request,
     then ``head`` truncates — so a golden/smoke run can take a short
     but structure-preserving prefix of a long log.

:class:`TraceInfo` reports the Sec. V-B catalog/working-set quantities
that predict FNA behaviour — request count, unique-key count, and the
top-1% popularity concentration — for the array actually returned
(i.e. after subsampling).

Aliases
-------
:func:`register_trace_file` binds a short name (plus default loader
kwargs) to a path; ``traces.get_trace`` resolves registered aliases and
the literal ``file:<path>`` spelling, so scenarios bind to log files
exactly like they bind to generators (see ``docs/scenarios.md``).
"""
from __future__ import annotations

import gzip
import hashlib
import io
import os
import zipfile
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional, Tuple, Union

import numpy as np

#: the literal-path trace-name prefix understood by ``traces.get_trace``
FILE_PREFIX = "file:"

#: the parse-cache schema tag of this package, part of every cache's
#: options digest (and so of its file name) and stored inside it: the JAX
#: package's caches (tag ``v1``) are never this package's hits
PARSE_TAG = "torch-v1"

#: alias -> {"path": ..., **loader kwargs} (see register_trace_file)
TRACE_FILES: Dict[str, dict] = {}

_GZIP_MAGIC = b"\x1f\x8b"


# ---------------------------------------------------------------------------
# TraceInfo: the Sec. V-B catalog / working-set statistics
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TraceInfo:
    """Catalog statistics of one loaded request array."""
    path: str                 # source file (or "<array>" for in-memory)
    fmt: str                  # "keys" | "csv" | "synthetic"
    n_requests: int           # requests in the returned array
    n_unique: int             # distinct keys in the returned array
    n_requests_file: int      # requests in the full file (pre-subsample)
    top1pct_ids: int          # ceil(1% of the catalog), >= 1
    top1pct_share: float      # fraction of requests to those hottest ids

    def to_dict(self) -> dict:
        return {
            "path": self.path, "format": self.fmt,
            "n_requests": self.n_requests, "n_unique": self.n_unique,
            "n_requests_file": self.n_requests_file,
            "top1pct_ids": self.top1pct_ids,
            "top1pct_share": round(self.top1pct_share, 6),
        }


def trace_info(ids: np.ndarray, path: str = "<array>", fmt: str = "synthetic",
               n_requests_file: Optional[int] = None) -> TraceInfo:
    """Compute :class:`TraceInfo` for any request array (works on the
    synthetic generators' output too)."""
    ids = np.asarray(ids)
    n = int(ids.shape[0])
    _, counts = np.unique(ids, return_counts=True)
    n_unique = int(counts.shape[0])
    top = max(1, -(-n_unique // 100))           # ceil(n_unique / 100)
    hottest = np.sort(counts)[::-1][:top]
    share = float(hottest.sum() / n) if n else 0.0
    return TraceInfo(path=str(path), fmt=fmt, n_requests=n,
                     n_unique=n_unique,
                     n_requests_file=int(n_requests_file
                                         if n_requests_file is not None else n),
                     top1pct_ids=top, top1pct_share=share)


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------

def _is_gzip(path: Path) -> bool:
    if path.suffix.lower() == ".gz":
        return True
    with open(path, "rb") as f:
        return f.read(2) == _GZIP_MAGIC


def _open_text(path: Path) -> io.TextIOBase:
    if _is_gzip(path):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "r", encoding="utf-8")


def infer_format(path: Union[str, Path]) -> str:
    """``.csv`` (optionally ``.gz``-wrapped) -> "csv", anything else ->
    "keys"."""
    p = Path(path)
    if p.suffix.lower() == ".gz":
        p = p.with_suffix("")
    return "csv" if p.suffix.lower() == ".csv" else "keys"


def _iter_keys(f: io.TextIOBase):
    """Yield raw key tokens of a ``keys``-format stream, one at a time."""
    for line in f:
        tok = line.strip()
        if not tok or tok.startswith("#"):
            continue
        yield tok


def _iter_csv(f: io.TextIOBase, key_column: Union[int, str],
              delimiter: str):
    """Yield raw key tokens of a ``csv``-format stream, one at a time."""
    import csv as _csv
    reader = _csv.reader(f, delimiter=delimiter)
    if isinstance(key_column, str):
        # the header is the first non-comment row (CDN exporters often
        # prepend banner lines)
        header = next((r for r in reader
                       if r and not r[0].startswith("#")), None)
        if header is None:
            return
        cols = [c.strip() for c in header]
        if key_column not in cols:
            raise ValueError(
                f"key column {key_column!r} not in CSV header {cols}")
        col = cols.index(key_column)
    else:
        col = int(key_column)
    for row in reader:
        if not row or row[0].startswith("#"):
            continue
        if col >= len(row):
            raise ValueError(
                f"CSV row {reader.line_num} has {len(row)} column(s), "
                f"key column is {col}")
        yield row[col].strip()


def _parse_keys(f: io.TextIOBase) -> list:
    return list(_iter_keys(f))


def _parse_csv(f: io.TextIOBase, key_column: Union[int, str],
               delimiter: str) -> list:
    return list(_iter_csv(f, key_column, delimiter))


def dense_remap(keys) -> np.ndarray:
    """Deterministically remap arbitrary key tokens to dense int64 ids in
    FIRST-APPEARANCE order (the id of a key is the number of distinct
    keys seen strictly before it)."""
    arr = np.asarray(keys)
    if arr.shape[0] == 0:
        return np.empty(0, dtype=np.int64)
    _, first, inv = np.unique(arr, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")    # uniques by first appearance
    rank = np.empty(order.shape[0], dtype=np.int64)
    rank[order] = np.arange(order.shape[0], dtype=np.int64)
    return rank[inv.reshape(-1)]


#: requests per chunk yielded by :func:`iter_trace_chunks` (and folded by
#: the streaming statistics pass) when the caller does not choose one
DEFAULT_CHUNK = 1 << 20


def _remap_chunk(tokens: list, mapping: Dict[str, int]) -> np.ndarray:
    """Dense-remap one chunk of raw key tokens against the cross-chunk
    ``mapping`` (token -> id, mutated in place).  Ids are assigned in
    global first-appearance order, so concatenating the chunk outputs is
    bit-identical to :func:`dense_remap` over the whole token stream.
    Only the chunk's DISTINCT tokens touch the dict — the bulk remap is
    a vectorised table lookup."""
    arr = np.asarray(tokens)
    uniq, first, inv = np.unique(arr, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")    # uniques by first appearance
    lut = np.empty(uniq.shape[0], dtype=np.int64)
    u_list = uniq.tolist()
    for ui in order.tolist():
        tok = u_list[ui]
        nid = mapping.get(tok)
        if nid is None:
            mapping[tok] = nid = len(mapping)
        lut[ui] = nid
    return lut[inv.reshape(-1)]


def iter_trace_chunks(path: Union[str, Path], fmt: Optional[str] = None,
                      key_column: Union[int, str] = 0, delimiter: str = ",",
                      chunk_size: int = DEFAULT_CHUNK,
                      remap: Optional[Dict[str, int]] = None):
    """Stream one log file as dense-remapped ``np.int64`` chunks.

    The generator holds O(chunk + catalog) memory — one chunk of raw
    tokens plus the token -> id dict — never the whole file.  The
    concatenation of the yielded chunks is BIT-IDENTICAL to
    :func:`parse_trace_file` on the same file: the dense remap is carried
    incrementally across chunks in first-appearance order.

    ``remap`` optionally supplies (and receives, mutated in place) the
    carry dict, so a caller can continue one id space across several
    files.

    A plain function returning the generator (not a generator itself) so
    a bad ``chunk_size`` raises HERE, at the call site, not at the first
    ``next()`` deep inside a consumer loop."""
    validate_chunk_size(chunk_size)
    return _iter_trace_chunks(Path(path), fmt, key_column, delimiter,
                              chunk_size, remap)


def validate_chunk_size(chunk_size) -> None:
    """Reject a non-int or < 1 ``chunk_size`` with a ValueError naming
    the argument (bool is an int subclass — reject it explicitly)."""
    if isinstance(chunk_size, bool) or \
            not isinstance(chunk_size, (int, np.integer)):
        raise ValueError(
            f"chunk_size must be an int >= 1, got {chunk_size!r}")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")


def _iter_trace_chunks(path: Path, fmt, key_column, delimiter, chunk_size,
                       remap):
    fmt = fmt or infer_format(path)
    mapping: Dict[str, int] = {} if remap is None else remap
    with _open_text(path) as f:
        if fmt == "keys":
            tokens = _iter_keys(f)
        elif fmt == "csv":
            tokens = _iter_csv(f, key_column, delimiter)
        else:
            raise ValueError(f"unknown trace format {fmt!r}; "
                             f"known: 'keys', 'csv'")
        buf: list = []
        for tok in tokens:
            buf.append(tok)
            if len(buf) >= chunk_size:
                yield _remap_chunk(buf, mapping)
                buf.clear()
        if buf:
            yield _remap_chunk(buf, mapping)


def parse_trace_file(path: Union[str, Path], fmt: Optional[str] = None,
                     key_column: Union[int, str] = 0,
                     delimiter: str = ",") -> np.ndarray:
    """Parse + dense-remap one log file (no cache, no subsampling).
    Implemented on the chunked iterator, so the one-shot parse and the
    streaming path share one id assignment by construction."""
    chunks = list(iter_trace_chunks(path, fmt=fmt, key_column=key_column,
                                    delimiter=delimiter))
    if not chunks:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(chunks)


def stream_trace_info(path: Union[str, Path], *, fmt: Optional[str] = None,
                      key_column: Union[int, str] = 0, delimiter: str = ",",
                      head: Optional[int] = None, stride: int = 1,
                      chunk_size: int = DEFAULT_CHUNK) -> TraceInfo:
    """:class:`TraceInfo` in ONE streaming pass — no full-array
    materialisation, O(chunk + catalog) memory.

    Matches ``load_trace_file(..., with_info=True)[1]`` exactly
    (including the top-1% concentration: the per-id request counts are
    the same integers, so the shares are the same floats).  Subsampling
    semantics mirror the loader: ``stride`` selects every stride-th
    request of the FULL file, then ``head`` truncates — ids still
    reflect full-file first-appearance order."""
    path = Path(path)
    fmt = fmt or infer_format(path)
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    counts = np.zeros(1024, dtype=np.int64)
    n_sel = 0           # requests selected into the subsampled view
    g = 0               # global request index (pre-subsample)
    for chunk in iter_trace_chunks(path, fmt=fmt, key_column=key_column,
                                   delimiter=delimiter,
                                   chunk_size=chunk_size):
        if stride > 1:
            first = (-g) % stride
            sel = chunk[first::stride]
            rank0 = (g + first) // stride   # global rank of sel[0]
        else:
            sel, rank0 = chunk, g
        if head is not None and sel.shape[0]:
            sel = sel[:max(0, min(sel.shape[0], int(head) - rank0))]
        if sel.shape[0]:
            bc = np.bincount(sel)
            if bc.shape[0] > counts.shape[0]:
                grown = np.zeros(max(2 * counts.shape[0], bc.shape[0]),
                                 dtype=np.int64)
                grown[:counts.shape[0]] = counts
                counts = grown
            counts[:bc.shape[0]] += bc
            n_sel += int(sel.shape[0])
        g += int(chunk.shape[0])            # keep counting for the file total
    nz = counts[counts > 0]
    n_unique = int(nz.shape[0])
    top = max(1, -(-n_unique // 100))       # ceil(n_unique / 100)
    hottest = np.sort(nz)[::-1][:top]
    share = float(hottest.sum() / n_sel) if n_sel else 0.0
    return TraceInfo(path=str(path), fmt=fmt, n_requests=n_sel,
                     n_unique=n_unique, n_requests_file=g,
                     top1pct_ids=top, top1pct_share=share)


# ---------------------------------------------------------------------------
# Content-hash .npz cache
# ---------------------------------------------------------------------------

#: in-process digest memo: (path, size, mtime_ns) -> sha256.  Repeated
#: loads of one unchanged log within a process (scenario run + TraceInfo
#: for the artifact, golden + display grids) hash the bytes once; any
#: on-disk change moves size/mtime and falls through to a fresh hash.
_SHA_MEMO: Dict[tuple, str] = {}


def file_sha256(path: Union[str, Path]) -> str:
    st = os.stat(path)
    memo_key = (str(path), st.st_size, st.st_mtime_ns)
    got = _SHA_MEMO.get(memo_key)
    if got is not None:
        return got
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    _SHA_MEMO[memo_key] = digest = h.hexdigest()
    return digest


def _cache_path(path: Path, cache_dir: Optional[Union[str, Path]],
                parse_key: str) -> Path:
    # one cache file PER parse-option set (short option digest in the
    # name), so e.g. two key columns of one CSV coexist instead of
    # thrashing a single slot
    opt = hashlib.sha256(parse_key.encode()).hexdigest()[:8]
    name = f"{path.name}.{opt}.npz"
    if cache_dir is not None:
        return Path(cache_dir) / name
    return path.with_name(name)


def _cache_candidates(path: Path, cache_dir: Optional[Union[str, Path]],
                      parse_key: str) -> list:
    """Cache locations in read/write preference order.  An explicit
    ``cache_dir`` wins outright; otherwise a ``REPRO_STORE`` root (its
    ``traces/`` subdirectory) is preferred, with the legacy
    next-to-source location as read fallback (pre-existing caches still
    hit) and write fallback (read-only store root).  Filename + keying
    are identical everywhere, so entries relocate freely."""
    if cache_dir is not None:
        return [_cache_path(path, cache_dir, parse_key)]
    from repro_torch.cachesim.store import default_root
    out = []
    root = default_root()
    if root is not None:
        out.append(_cache_path(path, root / "traces", parse_key))
    out.append(_cache_path(path, None, parse_key))
    return out


def _load_cached(cache: Path, digest: str, parse_key: str
                 ) -> Optional[np.ndarray]:
    try:
        with np.load(cache, allow_pickle=False) as z:
            if str(z["sha256"]) == digest and str(z["parse_key"]) == parse_key:
                return z["ids"].astype(np.int64, copy=False)
    except (OSError, KeyError, ValueError, zipfile.BadZipFile):
        pass          # corrupt / foreign / stale-schema cache: re-parse
    return None


def _write_cache(cache: Path, digest: str, parse_key: str,
                 ids: np.ndarray) -> bool:
    try:
        cache.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_name(f".{cache.name}.tmp{os.getpid()}.npz")
        np.savez_compressed(tmp, ids=ids, sha256=np.asarray(digest),
                            parse_key=np.asarray(parse_key))
        # atomic replace: a concurrent reader never sees a partial archive
        os.replace(tmp, cache)
        return True
    except OSError:
        return False  # read-only location — caller may try a fallback


# ---------------------------------------------------------------------------
# The loader
# ---------------------------------------------------------------------------

def load_trace_file(path: Union[str, Path], *, fmt: Optional[str] = None,
                    key_column: Union[int, str] = 0, delimiter: str = ",",
                    head: Optional[int] = None, stride: int = 1,
                    cache: bool = True,
                    cache_dir: Optional[Union[str, Path]] = None,
                    with_info: bool = False,
                    ) -> Union[np.ndarray, Tuple[np.ndarray, TraceInfo]]:
    """Load one request log into the simulator's ``np.int64`` contract.

    Parsing + dense remapping run once per file CONTENT (SHA-256-keyed
    ``.npz`` cache; location per :func:`_cache_candidates` — explicit
    ``cache_dir``, else the ``REPRO_STORE`` root's ``traces/``, else
    next to the source); subsampling (``stride`` then ``head``) is a
    cheap slice of the cached full array, so every (head, stride) view
    of one log shares one parse.  ``with_info=True`` additionally
    returns the :class:`TraceInfo` of the returned (post-subsample)
    array.
    """
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"trace file not found: {path}")
    fmt = fmt or infer_format(path)
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    parse_key = f"{PARSE_TAG}:{fmt}:{key_column}:{delimiter}"
    ids = None
    digest = None
    candidates = _cache_candidates(path, cache_dir, parse_key)
    if cache:
        digest = file_sha256(path)
        for cpath in candidates:
            if cpath.exists():
                ids = _load_cached(cpath, digest, parse_key)
                if ids is not None:
                    break
    if ids is None:
        ids = parse_trace_file(path, fmt=fmt, key_column=key_column,
                               delimiter=delimiter)
        if cache:
            for cpath in candidates:
                if _write_cache(cpath, digest, parse_key, ids):
                    break
    n_file = int(ids.shape[0])
    out = ids[::stride] if stride > 1 else ids
    if head is not None:
        out = out[:int(head)]
    out = np.ascontiguousarray(out, dtype=np.int64)
    if not with_info:
        return out
    return out, trace_info(out, path=str(path), fmt=fmt,
                           n_requests_file=n_file)


# ---------------------------------------------------------------------------
# Alias registry + get_trace integration
# ---------------------------------------------------------------------------

def register_trace_file(name: str, path: Union[str, Path],
                        **loader_kwargs) -> None:
    """Bind a short trace name to a log file (+ default loader kwargs).
    The path is checked lazily — at load, not registration — so modules
    may register aliases for files that appear later.  Re-registering a
    name with identical bindings is a no-op; a conflicting rebind
    raises."""
    if name in ("",) or name.startswith(FILE_PREFIX):
        raise ValueError(f"invalid trace-file alias {name!r}")
    from repro_torch.cachesim.traces import TRACES
    if name in TRACES:
        raise ValueError(
            f"alias {name!r} shadows a built-in synthetic generator")
    spec = {"path": str(path), **loader_kwargs}
    old = TRACE_FILES.get(name)
    if old is not None and old != spec:
        raise ValueError(f"trace-file alias {name!r} already bound to {old}")
    TRACE_FILES[name] = spec


def is_trace_file(name: str) -> bool:
    """Does ``name`` denote a file-backed trace (alias or ``file:``)?"""
    return name.startswith(FILE_PREFIX) or name in TRACE_FILES


def resolve(name: str, **overrides) -> dict:
    """The loader kwargs (incl. ``path``) a trace name denotes; call-site
    ``overrides`` win over the alias' registered defaults."""
    if name.startswith(FILE_PREFIX):
        spec = {"path": name[len(FILE_PREFIX):]}
    elif name in TRACE_FILES:
        spec = dict(TRACE_FILES[name])
    else:
        raise KeyError(f"not a file-backed trace: {name!r}")
    spec.update(overrides)
    return spec


def get_file_trace(name: str, n: Optional[int] = None,
                   with_info: bool = False, **kwargs):
    """``traces.get_trace`` backend for file-backed names: ``n`` bounds
    the returned length (``head`` subsample; an explicit ``head`` kwarg
    wins).  ``seed`` is accepted-and-ignored so generator-shaped call
    sites work unchanged (file replay is deterministic by nature)."""
    kwargs.pop("seed", None)
    spec = resolve(name, **kwargs)
    spec.setdefault("head", n)
    path = spec.pop("path")
    return load_trace_file(path, with_info=with_info, **spec)
