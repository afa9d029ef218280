"""Content-addressed artifact store: never compute the same sweep twice —
the port of the JAX package's ``repro.cachesim.store``.

The fast engine's expensive phase is the policy-independent system sweep
(:class:`~repro_torch.cachesim.systemstate.SystemTrace`); decision tables
are second.  Both are pure functions of durable inputs — the request trace's
BYTES and the ``SystemTrace.system_key`` configuration tuple (plus, for
tables, the provider's decision-side ``cache_key``) — so repeated figure
runs, CI golden jobs, and a fleet of sweep workers can share one artifact
pool instead of recomputing.

Key anatomy
-----------
An entry's filename is ``sha256(meta)`` of a human-readable meta string::

    torch-v<SCHEMA_VERSION>|sweep|<trace sha256>|<repr(system_key)>
    torch-v<SCHEMA_VERSION>|table|<trace sha256>|<repr(system_key)>|<device type>|<repr(table_key)>

so any input change — a single trace byte, any system-side config field,
a decision-side table key, or the serialisation schema itself — lands on
a different filename and the old entry is simply never consulted again.

Two parts of the key are this package's own:

  * the ``torch-`` prefix (:data:`KEY_PREFIX`).  The JAX package keys its
    entries ``v<N>|...`` with the same ``system_key`` text (dataclass
    reprs carry no module name), so without the prefix a shared
    ``REPRO_STORE`` would hand a reference sweep to a port run and hide
    a port fault.  Neither package's entries are ever the other's hits;
  * the device type a table was built on (``cpu`` or ``cuda``).  DS_PGM
    tables on the card may differ from the CPU's inside the ~1e-12
    near-tie dead-band, so a card-built table is never loaded into a CPU
    run nor the other way round.  Exhaustive, HOCS and scalar tables are
    bit-exact on either device; one rule keys them all.

Sweeps are host NumPy, identical on every device: one stored sweep
hydrates onto whichever device the loading run uses.
The meta string is also stored INSIDE the ``.npz`` payload and verified
on load, so a hash collision or a foreign file in the store directory
reads as a miss, never as wrong data.

Layout and durability
---------------------
::

    <root>/sweeps/<digest>.npz   SystemTrace snapshots (see
                                 SystemTrace.to_arrays: per-request
                                 arrays, view-version history, quality
                                 counters, final-state snapshot)
    <root>/tables/<digest>.npz   plan_cache decision tables ([V * 2^n]
                                 int64 selection bitmasks)
    <root>/traces/               the tracefiles.py parse cache (same
                                 filename scheme as next-to-source)
    <root>/spill/                scratch memmaps of chunked sweeps
                                 (``spill_dir``; not entries)

Writes are atomic (``os.replace`` of a same-directory temp file), so a
concurrent reader — or a second writer racing on the same entry — never
observes a partial archive; last writer wins with identical content.
A corrupt or truncated entry is treated as a miss, unlinked best-effort,
and rebuilt from scratch.

Hydrated sweeps replay **bit-identically** to cold compute: the replay
phase consumes exactly the arrays the store round-trips (float64/int64
binary, no text formatting); ``tests/test_torch_store.py`` asserts it.

``REPRO_STORE`` (environment) names a default root for the CLI
(``python -m repro_torch.tools.store_tool``) and the tracefiles parse
cache; library callers pass a root or an :class:`ArtifactStore`
explicitly (``run_grid(store=...)``).
"""
from __future__ import annotations

import hashlib
import itertools
import os
import zipfile
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

#: bumped whenever the serialised layout (SystemTrace.to_arrays schema,
#: table payload shape) changes — old entries then miss by construction.
#: v2: advert-event subsystem (per-node advert streams + token-bucket
#: state in the sweep snapshot; system_key grew the advert spec)
#: v3: hierarchical topologies (``repro_torch.cachesim.topology``) — the sweep
#: payload gained ``fwd_pos``, the forwarded residency-miss positions a
#: parent tier consumes; per-tier sweeps are stored under the SAME
#: (trace digest, system key) scheme, keyed by each tier's own arrival
#: stream, so one stored tier is reused by every topology cell (and
#: depth) that routes the same stream into the same system config
SCHEMA_VERSION = 3

#: this package's key prefix (see the module docstring): the JAX package's
#: entries start ``v<SCHEMA_VERSION>|`` and are never this store's hits
KEY_PREFIX = "torch-v"

#: distinct spill-directory suffixes within one process
_SPILL_SEQ = itertools.count()

#: environment variable naming the default store root (CLI + tracefiles)
ENV_VAR = "REPRO_STORE"


def default_root() -> Optional[Path]:
    """The ``REPRO_STORE`` root, or None when unset/empty."""
    root = os.environ.get(ENV_VAR, "").strip()
    return Path(root) if root else None


def as_store(store) -> Optional["ArtifactStore"]:
    """Normalise a ``store=`` argument: None passes through, a path
    becomes an :class:`ArtifactStore`, a store is returned as-is."""
    if store is None or isinstance(store, ArtifactStore):
        return store
    return ArtifactStore(store)


class ArtifactStore:
    """One store root; see the module docstring for the layout/keying."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        #: observability counters (benchmarks record them per run)
        self.stats: Dict[str, int] = {
            "sweep_hits": 0, "sweep_misses": 0,
            "table_hits": 0, "table_misses": 0,
            "writes": 0, "corrupt_dropped": 0,
        }

    def __repr__(self) -> str:
        return f"ArtifactStore({str(self.root)!r})"

    # -- keying ------------------------------------------------------------

    @staticmethod
    def trace_digest(trace: np.ndarray) -> str:
        """SHA-256 of the trace CONTENT in the engine's canonical dtype
        (uint64, the form ``run_cells`` hands to the sweep) — workers and
        parents hash identical bytes regardless of the caller's dtype."""
        arr = np.ascontiguousarray(np.asarray(trace), np.uint64)
        return hashlib.sha256(arr.tobytes()).hexdigest()

    @staticmethod
    def sweep_meta(trace_digest: str, system_key: tuple) -> str:
        return (f"{KEY_PREFIX}{SCHEMA_VERSION}|sweep|{trace_digest}|"
                f"{system_key!r}")

    @staticmethod
    def table_meta(trace_digest: str, system_key: tuple, device_type: str,
                   table_key: tuple) -> str:
        """A table's key: ``device_type`` (``"cpu"``, ``"cuda"``) is the
        device it was built on."""
        return (f"{KEY_PREFIX}{SCHEMA_VERSION}|table|{trace_digest}|"
                f"{system_key!r}|{device_type}|{table_key!r}")

    def _path(self, kind: str, meta: str) -> Path:
        digest = hashlib.sha256(meta.encode()).hexdigest()
        return self.root / f"{kind}s" / f"{digest}.npz"

    @property
    def traces_dir(self) -> Path:
        """Where the tracefiles parse cache lives under this root."""
        return self.root / "traces"

    def spill_dir(self) -> Path:
        """A fresh scratch directory under ``<root>/spill`` for the
        chunked sweep's per-request output memmaps (see
        ``SystemTrace.compute(spill=...)``).  Unique per call, so
        concurrent sweeps never collide.  Spill files are SCRATCH, not
        content-addressed entries: the caller deletes the directory when
        the arrays are no longer referenced (``entries``/``verify``/
        ``gc`` ignore it)."""
        d = self.root / "spill" / f"{os.getpid()}-{next(_SPILL_SEQ)}"
        d.mkdir(parents=True, exist_ok=True)
        return d

    # -- low-level entry IO ------------------------------------------------

    def _write(self, path: Path, arrays: Dict[str, np.ndarray],
               meta: str) -> None:
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f".{path.name}.tmp{os.getpid()}")
            # uncompressed: sweeps are large and mostly incompressible
            # bool/float arrays; load speed is the whole point
            with open(tmp, "wb") as f:
                np.savez(f, __meta__=np.asarray(meta), **arrays)
            os.replace(tmp, path)        # atomic: readers never see partial
            self.stats["writes"] += 1
        except OSError:
            pass                         # read-only root etc.: best-effort

    def _read(self, path: Path, meta: str) -> Optional[Dict[str, np.ndarray]]:
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["__meta__"]) != meta:
                    return None          # foreign/colliding entry: miss
                out = {k: z[k] for k in z.files if k != "__meta__"}
            # touch-on-hit: ``store_tool gc`` deletes oldest-mtime first
            # (documented as LRU) — without refreshing mtime on reads it
            # would evict the WARMEST entries under a long-lived store
            try:
                os.utime(path)
            except OSError:
                pass                     # read-only root etc.: best-effort
            return out
        except FileNotFoundError:
            return None
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            # corrupt / truncated: drop so the rebuild can land cleanly
            self.stats["corrupt_dropped"] += 1
            try:
                path.unlink()
            except OSError:
                pass
            return None

    # -- sweeps ------------------------------------------------------------

    def has_sweep(self, trace_digest: str, system_key: tuple) -> bool:
        """Cheap existence probe (no load/verify) — the parallel runner
        uses it to skip farming already-stored groups."""
        return self._path("sweep",
                          self.sweep_meta(trace_digest, system_key)).exists()

    def load_sweep(self, trace: np.ndarray, system_key: tuple, *,
                   device, trace_digest: Optional[str] = None):
        """The stored :class:`SystemTrace` for (trace bytes, system_key),
        hydrated against ``trace`` onto ``device``, or None on a miss."""
        from repro_torch.cachesim.systemstate import SystemTrace
        if trace_digest is None:
            trace_digest = self.trace_digest(trace)
        meta = self.sweep_meta(trace_digest, system_key)
        arrays = self._read(self._path("sweep", meta), meta)
        if arrays is None:
            self.stats["sweep_misses"] += 1
            return None
        self.stats["sweep_hits"] += 1
        return SystemTrace.from_arrays(arrays, key=system_key, trace=trace,
                                       device=device)

    def save_sweep(self, st, *, trace_digest: Optional[str] = None) -> None:
        """Persist one computed sweep (its ``plan_cache`` tables are
        separate artifacts — see :meth:`save_table`)."""
        if trace_digest is None:
            trace_digest = self.trace_digest(st._trace)
        meta = self.sweep_meta(trace_digest, st.key)
        self._write(self._path("sweep", meta), st.to_arrays(), meta)

    # -- decision tables ---------------------------------------------------

    def load_table(self, trace_digest: str, system_key: tuple,
                   table_key: tuple, device) -> Optional[torch.Tensor]:
        """The [V * 2^n] int64 table stored for a run on ``device``'s type,
        as a tensor on ``device``, or None on a miss."""
        device = torch.device(device)
        meta = self.table_meta(trace_digest, system_key, device.type,
                               table_key)
        arrays = self._read(self._path("table", meta), meta)
        if arrays is None:
            self.stats["table_misses"] += 1
            return None
        self.stats["table_hits"] += 1
        return torch.as_tensor(
            np.ascontiguousarray(arrays["table"], np.int64), device=device)

    def save_table(self, trace_digest: str, system_key: tuple,
                   table_key: tuple, table) -> None:
        """Persist one table, keyed on the device type it lies on (a NumPy
        array counts as a host-built, ``cpu`` table)."""
        table = torch.as_tensor(table)
        meta = self.table_meta(trace_digest, system_key, table.device.type,
                               table_key)
        self._write(self._path("table", meta),
                    {"table": table.cpu().numpy().astype(np.int64,
                                                         copy=False)}, meta)

    # -- maintenance (python -m repro_torch.tools.store_tool) ---------------

    def entries(self) -> List[Tuple[Path, str, int, float]]:
        """Every stored artifact as (path, kind, size bytes, mtime),
        oldest first — traces/ parse caches included."""
        out = []
        for kind in ("sweeps", "tables", "traces"):
            d = self.root / kind
            if not d.is_dir():
                continue
            for p in sorted(d.iterdir()):
                if p.name.startswith(".") or not p.is_file():
                    continue
                st = p.stat()
                out.append((p, kind, st.st_size, st.st_mtime))
        out.sort(key=lambda e: e[3])
        return out

    def verify(self) -> Iterator[Tuple[Path, bool]]:
        """Yield (path, ok) per entry: ok means the archive opens and its
        arrays load (traces/ entries are checked as archives only — their
        keying lives in ``tracefiles``)."""
        for path, _, _, _ in self.entries():
            ok = True
            try:
                with np.load(path, allow_pickle=False) as z:
                    for k in z.files:
                        z[k]
            except (OSError, KeyError, ValueError, zipfile.BadZipFile):
                ok = False
            yield path, ok

    def gc(self, max_bytes: int) -> List[Path]:
        """Delete oldest entries (by mtime) until the store fits in
        ``max_bytes``; returns the deleted paths."""
        entries = self.entries()
        total = sum(size for _, _, size, _ in entries)
        deleted = []
        for path, _, size, _ in entries:
            if total <= max_bytes:
                break
            try:
                path.unlink()
                total -= size
                deleted.append(path)
            except OSError:
                pass
        return deleted
