"""The benchmark's harness: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; the harness finds each by
name (``bench/configs/<config>.json`` with its plain reference
``bench/reference/<config>.py``, ``bench/traffic/<traffic>.json``, the
correctness limits ``bench/limits/<cell>.json``) and every per-layer
metric by its own name (``bench/metrics/<metric>.py``, a ``read(run)``
that returns a number or None), so that a later cell, mix or metric is a
matter of new files and entries.

A run: draw the weights (``bench.weights``) and hand them to the
program's ``ServeEngine``; build the prefix-cache cluster
(``PrefixServeCluster``); set up by routing the stream's first requests
through the same cluster until the caches are full, then give the caches
their prefills (``warm.prefill`` in the traffic file: ``resident``
prefills every document the caches hold once set-up's routing is done,
``template`` stores copies of one prefill for documents that never
return) and warm decode; then serve the window: one client, a closed
loop, for ``--seconds``.  Each request of the window is the body of the
program's serving launcher (``repro_torch.launch.serve``), called as it
is there: ``cluster.request(label, make_kv)`` routes, ``make_kv``
prefills on a miss (``ServeEngine.prefill`` to a device sync), and
``ServeEngine.decode(kv, first, n_out)`` decodes.  Around those calls the
harness keeps its own clock and records which nodes the router probed
(each node's ``lookup``) and when each decode step began (the model's
``decode_step``), which gives the first token's time.  With ``--trace 1``
``torch.profiler`` covers a slice of the window's requests.  After the
window the program's state is freed and what it produced is checked
(``bench.check``).
"""
from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from bench import check, streams, trace, weights

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: modules that may not be loaded in the process that prints the result
#: (the JAX package and JAX itself), by whole top-level name
BARRED = ("jax", "jaxlib", "flax", "repro")
#: what set-up's routing stores for a document that ``fill_resident``
#: prefills later
STAND_IN = object()


@dataclass
class Request:
    label: int
    phase: str                       # "setup" or "window"
    hit: bool = True
    probes: Tuple[int, ...] = ()
    route_s: float = 0.0             # request() less the prefill
    prefill_s: float = 0.0
    ttft_s: float = 0.0              # route + prefill + first decode step
    decode_s: float = 0.0
    tokens: Tuple[int, ...] = ()
    traced: bool = False


@dataclass
class Run:
    """What a per-layer metric reader sees."""
    cfg: object                      # the program's ModelConfig
    traffic: Dict
    requests: List[Request]          # the window's untraced requests
    stats: Dict                      # RouteStats counted over the window
    trace: Optional[trace.DeviceTrace]
    device: Dict


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict                     # the configuration file
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    reference: object = field(repr=False, default=None)
    bench: Path = BENCH              # where its files were found

    def metric(self, name: str):
        """The reader of per-layer metric ``name``."""
        return _module(self.bench / "metrics" / f"{name}.py", name)


def _json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        "bench_" + "".join(c if c.isalnum() else "_" for c in name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _merge(base: Dict, over: Optional[Dict]) -> Dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def load_cell(workload: str, root: Path = ROOT,
              model_over: Optional[Dict] = None,
              traffic_over: Optional[Dict] = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with everything it
    names, found by name under ``root/bench/``."""
    root = Path(root)
    bench = root / "bench"
    spec = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = _json(root / conf["file"])
    config["model"] = _merge(config["model"], model_over)
    mine = [m for m in spec["end_to_end"]
            if workload in m.get("workloads", [workload])]
    layer = [m for m in spec["per_layer"]
             if workload in m.get("workloads", [workload])]
    return Cell(workload, w["chips"], config,
                _merge(_json(bench / "traffic" / f"{w['traffic']}.json"),
                       traffic_over),
                _json(bench / "limits" / f"{workload}.json"), mine, layer,
                _module(bench / "reference" / f"{w['config']}.py",
                        w["config"]), bench)


def process_start() -> float:
    """This process's start, seconds since the epoch (from /proc, so that
    interpreter start-up and imports count as set-up)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        import os
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reads it."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class Server:
    """The program under test, driven as the serving launcher drives it,
    with the harness's clocks and probes around its calls."""

    def __init__(self, cell: Cell, seed: int, device):
        import torch

        from repro_torch.configs.base import ModelConfig
        from repro_torch.models import init_params
        from repro_torch.serving import (ClusterConfig, PrefixServeCluster,
                                         ServeEngine)

        self.torch = torch
        self.device = torch.device(device)
        self.cfg = ModelConfig(**cell.config["model"])
        tr = cell.traffic
        self.params = weights.draw(init_params(self.cfg, device="meta"),
                                   seed, self.device)
        self.engine = ServeEngine(self.cfg, params=self.params,
                                  device=self.device)
        self.cluster = PrefixServeCluster(ClusterConfig(**tr["cluster"]),
                                          seed=tr["stream"]["router_seed"])
        self.docs = streams.Documents(seed, self.cfg.vocab, tr["prefix_len"])
        self.max_len = tr["prefix_len"] + tr["n_out"] + 2
        self.n_out = tr["n_out"]
        self.first = np.zeros((1,), np.int32)
        self.prefills: Dict[int, list] = {}     # label -> window logits
        self.template = None
        self._probes: List[int] = []
        self._steps: List[float] = []
        self.profiling = False
        for j, node in enumerate(self.cluster.nodes):
            node.lookup = self._probe(j, node.lookup)
        model = self.engine.model
        step = model.decode_step

        def timed_step(*a, **k):
            self._steps.append(time.perf_counter())
            return step(*a, **k)
        model.decode_step = timed_step

    def _probe(self, j, lookup):
        def probed(key):
            self._probes.append(j)
            return lookup(key)
        return probed

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def profiler(self):
        """A ``torch.profiler.profile`` of the host and of the card."""
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def span(self, name):
        if not self.profiling:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def _prefill(self, label: int, rec: Optional[Request] = None):
        with self.span("bench.prefill"):
            t = time.perf_counter()
            logits, kv = self.engine.prefill(self.docs(label),
                                             max_len=self.max_len)
            self.sync()
        if rec is not None:
            rec.prefill_s = time.perf_counter() - t
            if rec.phase == "window":
                self.prefills.setdefault(label, []).append(logits)
        return kv

    def serve(self, label: int, phase: str, decode: bool = True,
              fill: Optional[str] = None) -> Request:
        """One request.  ``fill`` (set-up only) stores, on a miss, a
        stand-in that ``fill_resident`` later prefills (``resident``) or a
        copy of the first prefill's cache (``template``: documents that
        never return) instead of prefilling; ``decode`` False: set-up that
        routes and does not decode."""
        rec = Request(label, phase)
        torch = self.torch

        def make_kv():
            rec.hit = False
            if fill == "resident":
                return STAND_IN
            if fill == "template" and self.template is not None:
                return {k: v.clone() if isinstance(v, torch.Tensor) else v
                        for k, v in self.template.items()}
            kv = self._prefill(label, rec)
            if fill == "template":
                self.template = kv
            return kv

        self._probes.clear()
        t0 = time.perf_counter()
        with self.span("bench.route"):
            kv, _ = self.cluster.request(label, make_kv)
        t1 = time.perf_counter()
        rec.probes, rec.route_s = tuple(self._probes), t1 - t0 - rec.prefill_s
        if decode:
            self._steps.clear()
            with self.span("bench.decode"):
                out, _ = self.engine.decode(kv, self.first, self.n_out)
            t2 = time.perf_counter()
            rec.decode_s = t2 - t1
            rec.ttft_s = (self._steps[1] if len(self._steps) > 1 else t2) - t0
            rec.tokens = tuple(int(t) for t in out[0])
        return rec

    def fill_resident(self) -> int:
        """Prefill every document whose cache entry is still a stand-in
        (the router's decisions do not depend on what a cache holds);
        returns how many."""
        n = 0
        for node in self.cluster.nodes:
            for label, kv in list(node.store.items()):
                if kv is STAND_IN:
                    node.store[label] = self._prefill(label)
                    n += 1
        return n

    def warm_decode(self, times: int) -> None:
        """Decode ``times`` times from a cached prefix: the window's decode
        shapes, warmed in set-up."""
        kv = self.template if self.template is not None else next(
            v for nd in self.cluster.nodes for v in nd.store.values())
        for _ in range(times):
            self.engine.decode(kv, self.first, self.n_out)
        self.sync()

    def stats(self) -> Dict:
        s = self.cluster.stats
        return {"requests": s.requests, "kv_hits": s.kv_hits,
                "prefills": s.prefills, "probes": s.probes,
                "neg_probes": s.neg_probes}


def _warm_profiler(server: Server):
    """Start the profiler once in set-up, so that its own start-up (CUPTI)
    does not land in the window."""
    torch = server.torch
    with server.profiler():
        torch.ones(8, device=server.device).sum()
        server.sync()


def barred_modules(names=None) -> List[str]:
    """The loaded modules (or ``names``) whose top-level name is barred."""
    names = list(sys.modules) if names is None else names
    return sorted(m for m in names if m.split(".")[0] in BARRED)


@dataclass
class Served:
    """What a run served: set-up's requests, the window's, their clocks
    and the router's counters at the window's two ends."""
    server: Server
    setup: List[Request]
    window: List[Request]
    failed: int
    setup_s: float
    window_s: float
    built_s: float
    stats0: Dict
    stats1: Dict
    filled: int = 0
    prof: object = None


def serve_cell(cell: Cell, seed: int, seconds: float, traced: bool,
               device="cuda", t_start: Optional[float] = None, patch=None,
               log=sys.stderr, requests: Optional[int] = None) -> Served:
    """Set up, then serve the window (profiling a slice of it when
    ``traced``) for ``seconds``, or ``requests`` requests if that comes
    first (the CPU tests' fixed amount of work)."""
    t_start = process_start() if t_start is None else t_start
    tr = cell.traffic
    t0 = time.perf_counter()
    server = Server(cell, seed, device)
    server.sync()
    built_s = time.perf_counter() - t0
    if patch is not None:
        patch(server)
    labels = streams.stream(tr)
    warm = tr["warm"]
    setup = [server.serve(int(labels[i]), "setup", decode=False,
                          fill=warm["prefill"])
             for i in range(warm["requests"])]
    filled = server.fill_resident() if warm["prefill"] == "resident" else 0
    server.warm_decode(warm["decodes"])
    if traced:
        _warm_profiler(server)
    server.sync()
    stats0 = server.stats()
    slice_at, slice_n = tr["trace"]["skip"], tr["trace"]["requests"]
    prof, slice_span = None, None
    window: List[Request] = []
    failed = 0
    w0 = time.perf_counter()
    setup_s = time.time() - t_start
    i = len(setup)
    while True:
        k = len(window)
        if traced and k == slice_at:
            prof = server.profiler()
            prof.__enter__()
            server.profiling = True
            slice_span = server.span(trace.SLICE)
            slice_span.__enter__()
        try:
            rec = server.serve(int(labels[i]), "window")
        except Exception:       # a failed request counts; the run goes on
            traceback.print_exc(file=log)
            failed += 1
            rec = Request(int(labels[i]), "window", tokens=(-1,))
        rec.traced = server.profiling
        window.append(rec)
        i += 1
        if server.profiling and (k + 1 == slice_at + slice_n or
                                 time.perf_counter() - w0 >= seconds):
            server.sync()
            slice_span.__exit__(None, None, None)
            prof.__exit__(None, None, None)
            server.profiling = False
        if time.perf_counter() - w0 >= seconds or i >= len(labels) or \
                len(window) == requests:
            break
    server.sync()
    window_s = time.perf_counter() - w0
    return Served(server, setup, window, failed, setup_s, window_s,
                  built_s, stats0, server.stats(), filled, prof)


def device_info(cell: Cell, server: Server) -> Dict:
    torch = server.torch
    on_card = server.device.type == "cuda"
    return {"platform": "gpu" if on_card else "cpu",
            "kind": (torch.cuda.get_device_name(server.device) if on_card
                     else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                server.device) if on_card else 0),
            "power_limit": power_limit() if on_card else "not read"}


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: Optional[float] = None,
             patch=None, log=sys.stderr, requests: Optional[int] = None
             ) -> Tuple[Dict, Dict]:
    """One run; returns (the result line's object, the checks)."""
    sv = serve_cell(cell, seed, seconds, traced, device, t_start, patch,
                    log, requests)
    server, window = sv.server, sv.window
    dev = device_info(cell, server)
    result = {"correct": False, "attempted": len(window),
              "failed": sv.failed, "metrics": {}, "device": dev}
    done = [r for r in window if r.tokens != (-1,)]
    if not traced:
        values = {"req_s": len(done) / sv.window_s,
                  "ttft_p90_ms": 1e3 * float(np.percentile(
                      [r.ttft_s for r in done], 90)),
                  "setup_s": sv.setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    else:
        dtrace = trace.from_profile(sv.prof) if sv.prof is not None \
            else None
        run = Run(server.cfg, cell.traffic,
                  [r for r in done if not r.traced],
                  {k: sv.stats1[k] - sv.stats0[k] for k in sv.stats1},
                  dtrace, dev)
        for m in cell.per_layer:
            value = cell.metric(m["name"]).read(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        if dtrace is not None:
            dev["busy_s"] = dtrace.busy_s()
            dev["window_s"] = dtrace.window_s
            result["breakdown"] = dtrace.breakdown()
    warm_s = sum(r.route_s + r.prefill_s + r.decode_s for r in sv.setup)
    print(f"summary: weights and engine {sv.built_s:.3f} s, set-up "
          f"requests {warm_s:.3f} s ({len(sv.setup)}, then {sv.filled} "
          f"resident documents prefilled), set-up "
          f"{sv.setup_s:.3f} s; window {sv.window_s:.3f} s, {len(window)} "
          f"requests, {sum(r.hit for r in window)} hits, prefill "
          f"{sum(r.prefill_s for r in window):.3f} s, decode "
          f"{sum(r.decode_s for r in window):.3f} s, route "
          f"{sum(r.route_s for r in window):.3f} s; peak "
          f"{dev['memory_peak_bytes']} B", file=log)
    t_check = time.perf_counter()
    checks, info = verify(cell, sv, seed)
    info["seconds"] = round(time.perf_counter() - t_check, 3)
    print("compared: " + ", ".join(f"{k} {v}" for k, v in info.items()),
          file=log)
    result["correct"] = sv.failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    result["checks"] = checks
    return result, checks


def free_program(server: Server) -> None:
    """Drop the program's engine, cluster and caches; the benchmark's
    weights and documents stay for the reference."""
    server.cluster = server.engine = server.template = None
    gc.collect()
    if server.device.type == "cuda":
        server.torch.cuda.empty_cache()


def verify(cell: Cell, sv: Served, seed: int, control: bool = False
           ) -> Tuple[Dict, Dict]:
    """The numbers compared, each beside its limit, and how much was
    compared.  Runs after the window, with the program's caches freed;
    the reference works from the benchmark's own weights and documents.
    ``control``: the fp8 reference's numbers in the program's place."""
    server = sv.server
    free_program(server)
    mism = check.route_mismatches(sv.setup + sv.window, cell.traffic)
    groups = check.sample(sv.window, seed,
                          cell.traffic["check"]["max_forwards"])
    got = check.compare(cell.reference, server.params, cell.config["model"],
                        server.docs, groups, server.prefills,
                        server.cfg.vocab, server.device, control=control)
    lim = cell.limits
    out = {"route_mismatch": {"value": mism,
                              "limit": lim["route_mismatch"]["limit"]}}
    for name in ("prefill_logit_err", "decode_gap"):
        out[name] = {"value": got[name], "limit": lim[name]["limit"]}
    info = {k: got[k] for k in ("forwards", "prefills_compared",
                                "tokens_compared")}
    info["requests_routed"] = len(sv.setup) + len(sv.window)
    return out, info
