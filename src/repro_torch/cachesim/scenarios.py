"""Declarative scenario registry: named experiment configurations — the
port of the JAX package's ``repro.cachesim.scenarios`` (the same 20
scenarios, field for field), run on a torch device.

The paper's evaluation (Figs. 1, 3-7) is a family of policy grids — each
figure fixes a system configuration, sweeps one axis (update interval,
indicator budget, cache size, cache count, miss penalty) over a set of
workloads, and compares every policy per cell.  A :class:`Scenario`
captures exactly that, declaratively:

  * ``traces``       — workload names (``repro_torch.cachesim.traces``), plus
                       optional per-trace generator knobs (catalog size,
                       skew, churn) via ``trace_kwargs``;
  * ``base``         — the common ``SimConfig`` fields (costs, sizes, bpe,
                       intervals, miss penalty, subroutine).  Per-cache
                       fields accept sequences (heterogeneous tiers);
  * ``axis/values``  — the swept field and its grid.  A value is a
                       scalar, a per-cache tuple, or a mapping of coupled
                       overrides (see ``repro_torch.cachesim.sweep``);
  * ``policies``     — the policy panel of the figure;
  * golden fields    — the small, fixed sub-grid pinned by the golden
                       differential suite (``tests/golden/``, the JAX
                       package's reference-engine results; the port never
                       rewrites them).

The registry covers the paper's Fig. 4-7 setups (homogeneous caches, one
cost vector) AND heterogeneous regimes the journal version (arXiv:
2203.09119) and the bandwidth-constrained follow-up (arXiv:2104.01386)
emphasise: cheap-small/expensive-large cache tiers, per-cache staggered
advertisement cadences, and delayed-view clients whose view of one cache
is persistently stale.

:func:`run_scenario` executes any scenario end-to-end through the
shared-SystemTrace grid runner and returns flat records;
:func:`scenario_grid` is the raw ``{(trace, label): {policy: result}}``
grid it flattens (the golden checks compare its results field for field).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.cachesim import tracefiles
from repro_torch.cachesim.simulator import SimConfig
from repro_torch.cachesim.sweep import (
    axis_column,
    cell_label,
    cell_overrides,
    hashable_label,
    run_grid,
    sweep_records,
)
from repro_torch.cachesim.traces import get_trace
from repro_torch.device import DeviceLike

#: the full policy panel of the heterogeneous figures
PANEL = ("fna", "fna_cal", "fno", "pi")
#: the homogeneous panel (Algorithm 1 requires identical costs)
PANEL_HOM = ("fna", "fna_cal", "fno", "hocs", "pi")


@dataclass(frozen=True)
class Scenario:
    """One named experiment configuration (see module docstring)."""
    name: str
    figure: str                      # paper figure, or "beyond" (new regime)
    description: str
    traces: Tuple[str, ...]
    axis: str                        # swept SimConfig field (the x-axis)
    values: tuple                    # scalars, per-cache tuples, or mappings
    base: Mapping = field(default_factory=dict)   # common SimConfig kwargs
    policies: Tuple[str, ...] = PANEL
    n_requests: int = 60_000         # reduced scale (CI / laptop)
    n_requests_full: int = 1_000_000 # paper scale
    seed: int = 1
    trace_kwargs: Mapping = field(default_factory=dict)  # per-trace knobs
    # --- golden differential sub-grid (reference-engine pinned).  Kept
    # small (a few thousand requests) but NON-degenerate: golden cells
    # must fire advertisements and estimate updates within the short run,
    # so their values/overrides may differ from the display grid ---------
    golden_values: Optional[tuple] = None   # default: first two axis values
    golden_traces: Optional[tuple] = None   # default: first trace
    golden_base: Mapping = field(default_factory=dict)   # extra overrides
    golden_n_requests: int = 5_000
    # --- hierarchical scenarios (repro_torch.cachesim.topology): TopoConfig
    # kwargs beyond ``base`` (kind, depth, fanout, per-tier mappings,
    # origin knobs).  None/empty -> the flat single-hop system ----------
    topology: Optional[Mapping] = None

    def config(self, **overrides):
        """The cell-independent base config (+ ad-hoc SimConfig
        overrides): a ``SimConfig``, or — for hierarchical scenarios —
        a ``TopoConfig`` wrapping it (``run_grid`` dispatches on the
        type)."""
        kw = dict(self.base)
        kw.update(overrides)
        kw.setdefault("seed", self.seed)
        cfg = SimConfig(**kw)
        if not self.topology:
            return cfg
        from repro_torch.cachesim.topology import TopoConfig
        return TopoConfig(base=cfg, **self.topology)

    def make_traces(self, n_requests: int,
                    names: Optional[Sequence[str]] = None) -> Dict:
        """Generate/load the scenario's workloads at ``n_requests``.
        Names resolve through :func:`~repro_torch.cachesim.traces.get_trace`,
        so a trace is a synthetic generator OR a file-backed trace
        (registered alias / ``file:<path>``); ``trace_kwargs`` carries
        per-trace generator knobs or loader kwargs respectively."""
        names = tuple(names if names is not None else self.traces)
        return {t: get_trace(t, n_requests, seed=self.seed,
                             **self.trace_kwargs.get(t, {}))
                for t in names}

    def file_trace_infos(self, n_requests: int,
                         names: Optional[Sequence[str]] = None) -> Dict:
        """``{name: TraceInfo dict}`` for the scenario's FILE-backed
        traces at the given subsample length (empty for generator-only
        scenarios) — the figure pipeline records these in its JSON
        artifacts so measured-workload runs stay self-describing."""
        names = tuple(names if names is not None else self.traces)
        out: Dict[str, dict] = {}
        for t in names:
            if tracefiles.is_trace_file(t):
                _, info = tracefiles.get_file_trace(
                    t, n_requests, with_info=True,
                    **self.trace_kwargs.get(t, {}))
                out[t] = info.to_dict()
        return out

    # -- golden sub-grid ---------------------------------------------------

    def golden_trace_names(self) -> Tuple[str, ...]:
        """The workloads of the pinned golden sub-grid (also the smoke
        grid's — keep every consumer on this one selection rule)."""
        return tuple(self.golden_traces or self.traces[:1])

    def golden_grid(self) -> Tuple[Dict, tuple]:
        """(traces, values) of the pinned golden sub-grid."""
        values = self.golden_values if self.golden_values is not None \
            else self.values[:2]
        traces = self.make_traces(self.golden_n_requests,
                                  names=self.golden_trace_names())
        return traces, values


SCENARIOS: Dict[str, Scenario] = {}


def _scenario(**kw) -> Scenario:
    sc = Scenario(**kw)
    if sc.name in SCENARIOS:
        raise ValueError(f"duplicate scenario {sc.name!r}")
    SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; known: "
                       f"{sorted(SCENARIOS)}") from None


def list_scenarios(figure: Optional[str] = None) -> List[Scenario]:
    out = [sc for sc in SCENARIOS.values()
           if figure is None or sc.figure == figure]
    return sorted(out, key=lambda sc: sc.name)


def scenario_grid(sc: Scenario, n_requests: Optional[int] = None,
                  engine: str = "fast", share_system: bool = True,
                  policies: Optional[Sequence[str]] = None,
                  golden: bool = False, store=None, workers: int = 0,
                  chunk_size: Optional[int] = None,
                  device: DeviceLike = None) -> Tuple[Dict, tuple]:
    """(grid, values): the scenario run through
    :func:`~repro_torch.cachesim.sweep.run_grid` — ``grid`` maps
    ``(trace, label)`` to ``{policy: SimResult or TopoResult}`` with every
    raw accumulator — and the axis values it ran.  This is
    :func:`run_scenario`'s grid step; see there for the arguments."""
    if golden:
        n_req = n_requests if n_requests is not None else sc.golden_n_requests
        traces, values = sc.golden_grid()
        if n_req != sc.golden_n_requests:
            traces = sc.make_traces(n_req, names=tuple(traces))
        base = sc.config(engine=engine, **sc.golden_base)
    else:
        n_req = n_requests if n_requests is not None else sc.n_requests
        traces, values = sc.make_traces(n_req), sc.values
        base = sc.config(engine=engine)
    grid = run_grid(traces, base, sc.axis, values,
                    policies=tuple(policies or sc.policies),
                    share_system=share_system, store=store,
                    workers=workers, chunk_size=chunk_size, device=device)
    return grid, values


def scenario_records(sc: Scenario, grid: Dict, values) -> List[dict]:
    """One flat record per (trace, cell, policy) of a
    :func:`scenario_grid` result — :func:`run_scenario`'s output."""
    records = sweep_records(grid, axis=sc.axis)
    # mapping cells carry coupled overrides beyond the axis label (Fig. 6
    # moves update_interval with cache_size): put them on the records so
    # artifacts stay self-describing
    extra = {cell_label(sc.axis, v): cell_overrides(sc.axis, v)
             for v in values if isinstance(v, Mapping)}
    col = axis_column(sc.axis)
    for rec in records:
        rec["scenario"] = sc.name
        for k, v in extra.get(hashable_label(rec[col]), {}).items():
            rec.setdefault(k, v)
    return records


def run_scenario(sc: Scenario, n_requests: Optional[int] = None,
                 engine: str = "fast", share_system: bool = True,
                 policies: Optional[Sequence[str]] = None,
                 golden: bool = False, store=None,
                 workers: int = 0,
                 chunk_size: Optional[int] = None,
                 device: DeviceLike = None) -> List[dict]:
    """Execute a scenario through the shared-SystemTrace grid runner on
    ``device`` (``None`` -> ``cuda``, raising without a GPU) and return
    one flat record per (trace, cell, policy).

    ``store``/``workers``/``chunk_size`` pass straight to
    :func:`~repro_torch.cachesim.sweep.run_grid`: a content-addressed
    artifact store for sweep/table reuse across runs, a phase-1 process
    pool over independent system-key groups, and streaming phase-1 sweeps
    over fixed-size trace slices (each bit-identical to the serial
    one-shot path).

    ``golden=True`` runs the pinned golden sub-grid (golden traces,
    values, base overrides and request count) instead of the display
    grid — the sub-grid is chosen to stay NON-degenerate at its short
    length, so it is also the right shape for smoke runs."""
    grid, values = scenario_grid(
        sc, n_requests=n_requests, engine=engine, share_system=share_system,
        policies=policies, golden=golden, store=store, workers=workers,
        chunk_size=chunk_size, device=device)
    return scenario_records(sc, grid, values)


# ===========================================================================
# Paper figures (reduced-scale grids; n_requests_full is the paper scale)
# ===========================================================================

_scenario(
    name="fig1_staleness",
    figure="fig1",
    description="FN/FP ratio of the advertised indicator vs update "
                "interval (paper Fig. 1: staleness manufactures false "
                "negatives; >10% beyond 1K insertions).",
    traces=("wiki", "gradle"),
    axis="update_interval",
    values=(16, 64, 256, 1024, 2048),
    base=dict(cache_size=2_000, bpe=14.0),
    policies=("fno",),
)

_scenario(
    name="fig1_staleness_tight",
    figure="fig1",
    description="Fig. 1 with a tight 4-bits-per-entry indicator: the FP "
                "floor rises, the staleness-driven FN growth stays.",
    traces=("wiki", "gradle"),
    axis="update_interval",
    values=(16, 64, 256, 1024, 2048),
    base=dict(cache_size=2_000, bpe=4.0),
    policies=("fno",),
)

_scenario(
    name="fig3_penalty",
    figure="fig3",
    description="Normalised cost vs miss penalty across all four "
                "workloads (paper Fig. 3).",
    traces=("wiki", "gradle", "scarab", "f2"),
    axis="miss_penalty",
    values=(50.0, 100.0, 500.0),
    base=dict(cache_size=2_000, update_interval=200),
    golden_traces=("gradle", "f2"),
    golden_values=(50.0, 500.0),
)

_scenario(
    name="fig3_penalty_shared",
    figure="fig3",
    description="Fig. 3's miss-penalty axis as a DECISION-SIDE grid "
                "(8 cells x all four workloads): every cell leaves "
                "SystemTrace.system_key unchanged, so the sweep runner "
                "computes ONE system sweep per trace and replays all "
                "penalty cells against it, ds_pgm tables stacked into a "
                "single batched call.",
    traces=("wiki", "gradle", "scarab", "f2"),
    axis="miss_penalty",
    values=(25.0, 50.0, 75.0, 100.0, 150.0, 250.0, 500.0, 1000.0),
    base=dict(cache_size=2_000, update_interval=200),
    golden_traces=("wiki", "scarab"),
    golden_values=(25.0, 1000.0),
)

_scenario(
    name="fig4_gradle",
    figure="fig4",
    description="Normalised cost vs update interval on the recency-biased "
                "gradle workload (paper Fig. 4's headline regime: "
                "staleness hurts FNO most where the working set moves).",
    traces=("gradle",),
    axis="update_interval",
    values=(16, 128, 512, 2048, 8192),
    base=dict(cache_size=2_000),
    golden_values=(64, 512),
)

_scenario(
    name="fig4_wiki",
    figure="fig4",
    description="Normalised cost vs update interval on the "
                "frequency-biased wiki workload (paper Fig. 4).",
    traces=("wiki",),
    axis="update_interval",
    values=(16, 128, 512, 2048, 8192),
    base=dict(cache_size=2_000),
    golden_values=(64, 512),
)

_scenario(
    name="fig5_indicator_size",
    figure="fig5",
    description="Normalised cost vs indicator budget (bits per entry) at "
                "the STALE advertisement cadence (paper Fig. 5, incl. the "
                "FNO anomaly: a LARGER indicator can hurt FNO; "
                "``fig5_indicator_size_fresh`` covers the short cadence).",
    traces=("wiki", "gradle"),
    axis="bpe",
    values=(2.0, 4.0, 8.0, 14.0, 22.0),
    base=dict(cache_size=2_000, update_interval=800),
    golden_values=(4.0, 14.0),
)

_scenario(
    name="fig5_indicator_size_fresh",
    figure="fig5",
    description="Fig. 5's second cadence: the same bits-per-entry sweep "
                "with 4x more frequent advertisements, so the FP budget "
                "rather than staleness dominates.",
    traces=("wiki", "gradle"),
    axis="bpe",
    values=(2.0, 4.0, 8.0, 14.0, 22.0),
    base=dict(cache_size=2_000, update_interval=200),
    golden_values=(4.0, 14.0),
)

_scenario(
    name="fig6_cache_size",
    figure="fig6",
    description="Actual mean cost vs cache size, update interval scaled "
                "with capacity (paper Fig. 6: FNA at a fraction of the "
                "capacity beats FNO at full size).",
    traces=("wiki",),
    axis="cache_size",
    values=tuple({"cache_size": s, "update_interval": max(s // 8, 16)}
                 for s in (500, 1_000, 2_000, 4_000)),
    base=dict(),
    seed=2,
    n_requests=80_000,
    n_requests_full=300_000,
    golden_values=tuple({"cache_size": s, "update_interval": max(s // 8, 16)}
                        for s in (500, 2_000)),
)

_scenario(
    name="fig7_num_caches",
    figure="fig7",
    description="Normalised cost vs number of (homogeneous, cost-2) "
                "caches (paper Fig. 7); includes Algorithm 1 (HOCS).",
    traces=("gradle",),
    axis="n_caches",
    values=tuple({"n_caches": n, "costs": (2.0,) * n} for n in (2, 3, 5, 7)),
    base=dict(cache_size=2_000, update_interval=800),
    policies=PANEL_HOM,
    golden_values=tuple({"n_caches": n, "costs": (2.0,) * n} for n in (2, 5)),
    golden_base=dict(update_interval=150),
)

# ===========================================================================
# Beyond-paper heterogeneous regimes (journal / follow-up emphasis)
# ===========================================================================

_scenario(
    name="hetero_tiers",
    figure="beyond",
    description="Cheap-small / expensive-large cache tiers: cost and "
                "capacity anti-correlated (1x/500 vs 4x/4000), so the "
                "selection trade-off is genuinely heterogeneous.",
    traces=("gradle", "scarab"),
    axis="update_interval",
    values=(64, 512, 2048),
    base=dict(costs=(1.0, 2.0, 4.0), cache_size=(500, 1_500, 4_000)),
    golden_values=(64, 512),
)

_scenario(
    name="staggered_adverts",
    figure="beyond",
    description="Per-cache advertisement cadences (the bandwidth-"
                "constrained regime of arXiv:2104.01386): the same total "
                "advertisement budget concentrated on different caches.",
    traces=("gradle",),
    axis="update_interval",
    values=((600, 600, 600), (100, 400, 1_600),
            (1_600, 400, 100), (50, 250, 5_000)),
    base=dict(cache_size=2_000),
    golden_values=((150, 150, 150), (50, 150, 600)),
)

_scenario(
    name="delayed_view",
    figure="beyond",
    description="A delayed-view client: one cache's advertisements are "
                "an order of magnitude rarer, so its client view is "
                "persistently stale while the others stay fresh.",
    traces=("wiki",),
    axis="update_interval",
    values=((200, 200, 200), (200, 200, 2_000), (200, 200, 20_000)),
    base=dict(cache_size=2_000, est_interval=25),
    golden_values=((200, 200, 200), (200, 200, 2_000)),
)

_scenario(
    name="advert_budget",
    figure="beyond",
    description="Self-adjusting advertisement under a token-bucket "
                "bandwidth budget (arXiv:2104.01386): cost vs advert "
                "bandwidth (bytes per insertion).  Caches advertise on "
                "Eq. (7) predicted-FN drift when the bucket covers a "
                "full indicator; tight budgets starve advertisement and "
                "staleness costs surface, generous ones approach the "
                "fresh-indicator regime.",
    traces=("gradle",),
    axis="advert_bandwidth",
    values=(0.5, 2.0, 8.0, 32.0),
    base=dict(cache_size=2_000, advert_policy="self_adjusting",
              advert_threshold=0.05, est_interval=50),
    golden_values=(2.0, 32.0),
)

_scenario(
    name="advert_delta",
    figure="beyond",
    description="Delta advertisement (arXiv:2405.17801): the periodic "
                "cadence with measured changed-bit delta encoding on the "
                "wire instead of the full bitmap — identical system "
                "evolution, different bytes-on-wire (the advert_bytes "
                "column), shrinking as the cadence tightens.",
    traces=("gradle",),
    axis="update_interval",
    values=(64, 256, 1_024),
    base=dict(cache_size=2_000, advert_policy="delta"),
    golden_values=(64, 256),
)

_scenario(
    name="exhaustive_small",
    figure="beyond",
    description="The exact Eq. (10) subroutine (exhaustive 2^n "
                "enumeration) on a 4-cache heterogeneous system — "
                "pins the batched exhaustive fast path end to end.",
    traces=("gradle",),
    axis="update_interval",
    values=(100, 800),
    base=dict(n_caches=4, costs=(1.0, 2.0, 3.0, 1.5),
              cache_size=1_500, alg="exhaustive"),
    n_requests=30_000,
    golden_values=(100, 800),
)

_scenario(
    name="heavy_skew",
    figure="beyond",
    description="Wiki-like workload at a much heavier skew and smaller "
                "catalog (alpha 1.2, 100K items): hits concentrate, "
                "false positives dominate the indicator error budget.",
    traces=("wiki",),
    axis="update_interval",
    values=(64, 512, 2_048),
    base=dict(cache_size=2_000),
    trace_kwargs={"wiki": dict(alpha=1.2, catalog=100_000)},
    golden_values=(64, 512),
)

# ===========================================================================
# Hierarchical topologies (repro_torch.cachesim.topology)
# ===========================================================================

_scenario(
    name="topo_path",
    figure="beyond",
    description="A PATH hierarchy on the recency-biased gradle workload: "
                "edge / regional / origin-side tiers with growing caches, "
                "slowing advertisement cadences, per-hop forward "
                "penalties, an admission queue at the middle tier and "
                "per-tier service latencies — normalised cost, mean "
                "latency and rejection rate vs hierarchy depth (depth 1 "
                "is the flat paper system).",
    traces=("gradle",),
    axis="depth",
    values=(1, 2, 3),
    base=dict(),
    topology=dict(
        kind="path", depth=3,
        tiers=(
            dict(cache_size=800, update_interval=150, tier_latency=1.0,
                 hop_penalty=5.0),
            dict(cache_size=2_000, update_interval=300, tier_latency=4.0,
                 hop_penalty=10.0, queue_capacity=36, queue_window=40),
            dict(cache_size=4_000, update_interval=600,
                 tier_latency=16.0),
        ),
        origin_latency=64.0),
    golden_values=(1, 3),
)

_scenario(
    name="topo_tree",
    figure="beyond",
    description="A 3-level TREE hierarchy (leaf edge caches fanning into "
                "regional parents into one root) on gradle: leaf "
                "admission queues reject a slice of arrivals, misses "
                "merge upward in trace order — cost/latency/rejection vs "
                "fan-out.",
    traces=("gradle",),
    axis="fanout",
    values=(2, 3),
    base=dict(),
    topology=dict(
        kind="tree", depth=3, fanout=2,
        tiers=(
            dict(cache_size=150, update_interval=40, tier_latency=1.0,
                 hop_penalty=5.0, queue_capacity=45, queue_window=50),
            dict(cache_size=400, update_interval=80, tier_latency=4.0,
                 hop_penalty=10.0),
            dict(cache_size=800, update_interval=150,
                 tier_latency=16.0),
        ),
        origin_latency=64.0),
    n_requests=40_000,
    golden_n_requests=4_000,
)

# ===========================================================================
# File-backed traces (repro_torch.cachesim.tracefiles)
# ===========================================================================

#: committed redistributable sample logs (tools/make_trace_file.py
#: --samples; generated from the synthetic generators, so license-clean):
#: one recency-biased stream in the line-per-key shape, one Zipf-like
#: stream in the CSV shape — the wiki/CDN log shapes the paper family's
#: measured workloads arrive in.  ``parents[3]`` of this file is the
#: repository root (src/repro_torch/cachesim/scenarios.py).
_DATA_DIR = Path(__file__).resolve().parents[3] / "tests" / "data"

tracefiles.register_trace_file(
    "sample_recency", _DATA_DIR / "sample_recency.log.gz")
tracefiles.register_trace_file(
    "sample_zipf", _DATA_DIR / "sample_zipf.csv.gz", key_column="key")

_scenario(
    name="trace_file_smoke",
    figure="beyond",
    description="The full policy panel on FILE-BACKED traces: both "
                "committed sample logs (line-per-key recency stream + "
                "CSV Zipf stream) replayed through the trace-ingestion "
                "loader — pins the measured-workload path (parse, dense "
                "remap, npz cache, head subsample) end to end.",
    traces=("sample_recency", "sample_zipf"),
    axis="update_interval",
    values=(100, 400, 1_600),
    base=dict(cache_size=800),
    golden_traces=("sample_recency", "sample_zipf"),
    golden_values=(100, 400),
)

#: scenarios pinned by the golden differential suite — every policy of
#: each (including fna_cal everywhere, the exhaustive subroutine via
#: ``exhaustive_small``, and the trace-file ingestion path via
#: ``trace_file_smoke``) is asserted bit-exact fast-vs-reference
GOLDEN_SCENARIOS = (
    "fig3_penalty", "fig3_penalty_shared", "fig4_gradle", "fig4_wiki",
    "fig7_num_caches", "hetero_tiers", "staggered_adverts", "delayed_view",
    "advert_budget", "advert_delta",
    "exhaustive_small", "heavy_skew", "trace_file_smoke",
    "topo_path", "topo_tree",
)
