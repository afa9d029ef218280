"""Write simulator request traces out as wiki/CDN-shaped log files — the
port of the JAX package's ``tools/make_trace_file.py`` on the port's own
``cachesim.traces`` and ``cachesim.tracefiles``.

Formats (mirroring the loader):

  * ``keys`` — one key token per line (wiki-access-log shape);
  * ``csv``  — ``ts,key,bytes`` rows with a header (CDN-log shape); keys
    are written as ``obj<id>`` string tokens so the loader's dense
    remapping of non-integer keys is exercised, ``bytes`` is a
    deterministic function of the key (no extra RNG).

``--gzip`` compresses with a zeroed mtime header, so regenerating a
sample yields byte-identical files.  The bytes written equal the
reference tool's for the same array and options.

Usage::

    # a generator, serialised
    PYTHONPATH=src python -m repro_torch.tools.make_trace_file \\
        --generator gradle --n 60000 --seed 7 --format keys --gzip \\
        -o gradle.log.gz

    # convert an existing log between shapes
    PYTHONPATH=src python -m repro_torch.tools.make_trace_file \\
        --input access.log --format csv -o out.csv

    # the sample logs (tests/data/ of the checkout, or -o DIR)
    PYTHONPATH=src python -m repro_torch.tools.make_trace_file --samples \\
        [-o DIR]
"""
from __future__ import annotations

import argparse
import gzip
import sys
from pathlib import Path

import numpy as np

from repro_torch.cachesim import tracefiles
from repro_torch.cachesim.traces import TRACES, get_trace

SAMPLES_DIR = Path(__file__).resolve().parents[3] / "tests" / "data"

#: the sample logs (from the synthetic generators, so license-clean): one
#: recency-biased stream in the line-per-key shape, one Zipf-like stream
#: in the CSV shape
SAMPLES = (
    dict(out="sample_recency.log.gz", generator="gradle", fmt="keys",
         n=60_000, seed=7, kwargs={}),
    dict(out="sample_zipf.csv.gz", generator="wiki", fmt="csv",
         n=60_000, seed=11, kwargs={"catalog": 50_000}),
)

#: rows serialised per write (a multi-GB log streams through O(chunk)
#: memory)
WRITE_CHUNK = 1 << 16


def _fake_bytes(key: int) -> int:
    """Deterministic CDN-ish object size column (Knuth hash, 1K..900K)."""
    return (int(key) * 2654435761) % 900_000 + 1_000


def _iter_text(ids: np.ndarray, fmt: str):
    """The log text in row chunks (the same bytes as one serialisation
    of the whole array)."""
    if fmt == "keys":
        yield "# one request key per line\n"
        for lo in range(0, len(ids), WRITE_CHUNK):
            block = ids[lo:lo + WRITE_CHUNK].tolist()
            yield "".join(f"{int(x)}\n" for x in block)
    elif fmt == "csv":
        yield "ts,key,bytes\n"
        for lo in range(0, len(ids), WRITE_CHUNK):
            block = ids[lo:lo + WRITE_CHUNK].tolist()
            yield "".join(f"{lo + i},obj{int(x)},{_fake_bytes(int(x))}\n"
                          for i, x in enumerate(block))
    else:
        raise ValueError(f"unknown format {fmt!r}; known: 'keys', 'csv'")


def write_trace_file(ids: np.ndarray, path: Path, fmt: str,
                     compress: bool = False) -> Path:
    """Serialise a request array into one of the loader's formats, a
    chunk at a time."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        if compress:    # mtime=0: the same bytes for the same input
            with gzip.GzipFile(fileobj=f, mode="wb", mtime=0) as gz:
                for text in _iter_text(ids, fmt):
                    gz.write(text.encode("utf-8"))
        else:
            for text in _iter_text(ids, fmt):
                f.write(text.encode("utf-8"))
    return path


def write_samples(out_dir: Path = SAMPLES_DIR) -> list:
    """Every ``SAMPLES`` log written under ``out_dir``; their paths."""
    paths = []
    for spec in SAMPLES:
        ids = get_trace(spec["generator"], spec["n"], seed=spec["seed"],
                        **spec["kwargs"])
        p = write_trace_file(ids, Path(out_dir) / spec["out"], spec["fmt"],
                             compress=True)
        info = tracefiles.trace_info(ids, path=str(p), fmt=spec["fmt"])
        print(f"  wrote {p}  ({info.n_requests} requests, {info.n_unique} "
              f"unique, top-1% share {info.top1pct_share:.3f})")
        paths.append(p)
    return paths


def _generator_kwargs(ap, pairs) -> dict:
    kwargs = {}
    for kv in pairs:
        k, sep, v = kv.partition("=")
        if not sep or not k:
            ap.error(f"--kw expects KEY=VALUE, got {kv!r}")
        try:
            kwargs[k] = int(v)
        except ValueError:
            try:
                kwargs[k] = float(v)
            except ValueError:
                ap.error(f"--kw {k}: generator knobs are numeric, got {v!r}")
    return kwargs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--generator", choices=TRACES,
                     help="serialise a synthetic generator")
    src.add_argument("--input", help="convert an existing log file "
                                     "(any loader-readable shape)")
    src.add_argument("--samples", action="store_true",
                     help="write the sample logs into -o DIR (default: "
                          "tests/data of the checkout)")
    ap.add_argument("--n", type=int, default=60_000,
                    help="generator request count (default 60000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kw", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="extra generator kwarg (repeatable), e.g. "
                         "--kw catalog=50000 --kw alpha=1.2")
    ap.add_argument("--input-format", choices=("keys", "csv"), default=None,
                    help="--input parse format (default: infer from suffix)")
    ap.add_argument("--key-column", default="0",
                    help="--input CSV key column: index or name (default 0)")
    ap.add_argument("--format", choices=("keys", "csv"), default="keys",
                    help="output shape (default keys)")
    ap.add_argument("--gzip", action="store_true", help="compress the output")
    ap.add_argument("-o", "--out", help="output path (with --samples: the "
                                        "directory)")
    args = ap.parse_args(argv)

    if args.samples:
        write_samples(Path(args.out) if args.out else SAMPLES_DIR)
        return 0
    if not args.out:
        ap.error("-o/--out is required (unless --samples)")
    if args.generator:
        ids = get_trace(args.generator, args.n, seed=args.seed,
                        **_generator_kwargs(ap, args.kw))
    elif args.input:
        key_column = (int(args.key_column) if args.key_column.isdigit()
                      else args.key_column)
        ids = tracefiles.load_trace_file(
            args.input, fmt=args.input_format, key_column=key_column,
            cache=False)
    else:
        ap.error("pass --generator, --input, or --samples")
    p = write_trace_file(ids, Path(args.out), args.format,
                         compress=args.gzip)
    info = tracefiles.trace_info(ids, path=str(p), fmt=args.format)
    print(f"wrote {p}: {info.n_requests} requests, {info.n_unique} unique, "
          f"top-1% share {info.top1pct_share:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
