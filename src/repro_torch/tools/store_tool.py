"""Inspect and maintain the port's content-addressed artifact store
(``repro_torch.cachesim.store``).

The store is append-only from the engine's point of view — entries are
immutable, keyed by content, and never updated in place — so the only
maintenance it ever needs is external: look at what accumulated, bound
its size, and check archive integrity after an unclean copy.

Usage::

    PYTHONPATH=src python -m repro_torch.tools.store_tool ls [--store DIR]
    PYTHONPATH=src python -m repro_torch.tools.store_tool gc --max-bytes N [--store DIR]
    PYTHONPATH=src python -m repro_torch.tools.store_tool verify [--store DIR]

``--store`` defaults to the ``REPRO_STORE`` environment variable.  It
needs neither JAX nor a GPU.

  * ``ls``     — every entry as ``kind  size  mtime  path``, oldest
    first, plus a per-kind and total summary.
  * ``gc``     — delete oldest entries (by mtime) until the store fits
    in ``--max-bytes`` (suffixes K/M/G accepted).  mtime order makes gc
    an LRU-ish eviction under CI's restore/save cycle.
  * ``verify`` — open every archive and load its arrays; corrupt
    entries are reported (and the engine would rebuild them on next
    touch anyway).  Exit code 1 if any entry fails.
"""
from __future__ import annotations

import argparse
import datetime
import sys


def _parse_bytes(s: str) -> int:
    """Parse a size like ``500M`` / ``1.5 GB`` / ``4096`` into bytes.

    Accepts an optional K/M/G multiplier with an optional trailing ``B``
    (any case); rejects negatives and anything unparseable with a clear
    ``argparse``-friendly error instead of a bare ``float()`` traceback.
    """
    raw = s
    s = s.strip().upper()
    if s.endswith("B"):
        s = s[:-1]
    mult = 1
    for suffix, m in (("K", 1 << 10), ("M", 1 << 20), ("G", 1 << 30)):
        if s.endswith(suffix):
            s, mult = s[:-1], m
            break
    try:
        val = float(s.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"invalid size {raw!r}: expected <number>[K|M|G][B], "
            f"e.g. 500M, 1.5GB, 4096")
    if val < 0:
        raise argparse.ArgumentTypeError(
            f"invalid size {raw!r}: must be non-negative")
    return int(val * mult)


def _fmt_size(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


def cmd_ls(store) -> int:
    entries = store.entries()
    totals: dict = {}
    for path, kind, size, mtime in entries:
        ts = datetime.datetime.fromtimestamp(mtime).strftime("%Y-%m-%d %H:%M")
        print(f"{kind:7s} {_fmt_size(size):>10s}  {ts}  {path}")
        n, b = totals.get(kind, (0, 0))
        totals[kind] = (n + 1, b + size)
    total_n = sum(n for n, _ in totals.values())
    total_b = sum(b for _, b in totals.values())
    for kind in sorted(totals):
        n, b = totals[kind]
        print(f"# {kind}: {n} entries, {_fmt_size(b)}")
    print(f"# total: {total_n} entries, {_fmt_size(total_b)}")
    return 0


def cmd_gc(store, max_bytes: int) -> int:
    deleted = store.gc(max_bytes)
    for p in deleted:
        print(f"deleted {p}")
    kept = sum(size for _, _, size, _ in store.entries())
    print(f"# deleted {len(deleted)} entries; {_fmt_size(kept)} kept "
          f"(limit {_fmt_size(max_bytes)})")
    return 0


def cmd_verify(store) -> int:
    bad = 0
    n = 0
    for path, ok in store.verify():
        n += 1
        if not ok:
            bad += 1
            print(f"CORRUPT {path}")
    print(f"# verified {n} entries, {bad} corrupt")
    return 1 if bad else 0


def main(argv=None) -> int:
    from repro_torch.cachesim.store import ArtifactStore, default_root

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tools.store_tool",
        description="Inspect / bound / verify a repro_torch artifact store")
    ap.add_argument("--store", default=None, metavar="DIR",
                    help="store root (default: $REPRO_STORE)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("ls", help="list entries oldest-first + summary")
    gc = sub.add_parser("gc", help="delete oldest entries over the limit")
    gc.add_argument("--max-bytes", required=True, metavar="N",
                    type=_parse_bytes,
                    help="target size (suffixes K/M/G[B] accepted)")
    sub.add_parser("verify", help="check every archive loads")
    args = ap.parse_args(argv)

    root = args.store or default_root()
    if root is None:
        ap.error("no store: pass --store or set REPRO_STORE")
    store = ArtifactStore(root)
    if args.cmd == "ls":
        return cmd_ls(store)
    if args.cmd == "gc":
        return cmd_gc(store, args.max_bytes)
    return cmd_verify(store)


if __name__ == "__main__":
    sys.exit(main())
