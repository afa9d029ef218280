"""Policy x trace x system-axis sweep runner (paper Figs. 4-7 grids) — the
port of the JAX package's ``repro.cachesim.sweep``, on one torch device.

The paper's headline claim — FNA matching FNO's cost with an order of
magnitude fewer advertised bits — is established on multi-dimensional
sweeps: every policy, over every workload, across a range of system
parameters (advertisement intervals, indicator budgets, cache sizes,
cache counts).  The system evolution is policy-independent (hash
placement), so each (trace, cell) computes its
:class:`~repro_torch.cachesim.systemstate.SystemTrace` exactly once and
replays every policy against it (via
:func:`repro_torch.cachesim.engine.run_cells`): a P-policy grid costs one
system sweep per cell plus P cheap replays, instead of P full simulations.

:func:`run_grid` sweeps an arbitrary ``SimConfig`` field.  A cell value
is one of:

  * a scalar — assigned to the swept field (``update_interval=512``);
  * a per-cache sequence — assigned as-is (staggered advertisement
    cadences: ``update_interval=(100, 400, 1600)``);
  * a mapping of several SimConfig overrides — for axes whose cells move
    coupled fields (paper Fig. 6 scales ``update_interval`` with
    ``cache_size``; Fig. 7 resizes the homogeneous cost vector with
    ``n_caches``).

Swept fields split into two kinds, classified per cell by
``SystemTrace.system_key``:

  * SYSTEM-side axes change the indicators or cache dynamics
    (``update_interval``, ``bpe``, ``cache_size``, ``n_caches``, ...):
    every cell is its own system evolution, so cells never share sweeps
    with each other — only policies within a cell do.
  * DECISION-side axes leave the system evolution untouched
    (``miss_penalty``, ``costs``, ``policy``, the calibration knobs):
    all their cells land in one group that computes a SINGLE
    :class:`~repro_torch.cachesim.systemstate.SystemTrace` per trace and
    replays every (cell, policy) against it, with each provider family's
    decision tables stacked into one batched call on the device
    (:func:`repro_torch.cachesim.engine.run_cells`; the exhaustive ones
    through the subset-DP kernel).  The paper's Fig. 3
    penalty grid thus costs one sweep per trace instead of one per cell.

:func:`run_grid` also carries the perf tier on top of the grouping:

  * ``store=`` consults the content-addressed artifact store
    (``repro_torch.cachesim.store``) so repeated grid runs never recompute
    a (trace bytes x system key) sweep or its decision tables;
  * ``workers=N`` runs the independent system-key groups' PHASE-1 sweeps
    in a spawn-based process pool, with the store as the cross-process
    hand-off: workers persist sweeps, then the ordinary serial pass runs
    entirely warm — so the parallel path is bit-identical to the serial
    one by construction (the replays are the same code on the same
    hydrated artifacts).  With no ``store`` given, a temporary store
    scoped to the call is used.  The workers run host phase 1 only and
    never touch CUDA: each builds its ``Simulator`` on the CPU, and the
    parent hydrates the stored sweep onto its own device.

The reference's ``backend=`` is ``device=`` here (``None`` -> ``cuda``,
raising without a GPU), and ``mesh`` (a 1-D ``("cells",)``
``DeviceMesh``, made over the process world when None and the world has
more than one rank) shards the DS_PGM table build's cell axis.

:func:`run_sweep` is the ``update_interval`` special case (Figs. 4-6),
kept as the stable entry point for benchmarks and tests.
"""
from __future__ import annotations

import dataclasses
import shutil
import tempfile
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.cachesim.simulator import SimConfig, SimResult
from repro_torch.cachesim.systemstate import SystemTrace
from repro_torch.cachesim.traces import get_trace
from repro_torch.device import DeviceLike, resolve_device

DEFAULT_POLICIES = ("fna", "fna_cal", "fno", "pi")

#: one grid-cell key: (trace name, axis label)
CellKey = Tuple[str, object]


def hashable_label(value):
    """Normalise an axis value into a hashable cell-key / record-label
    component (lists/arrays -> tuples, numpy scalars -> Python scalars).
    Public: the figure pipeline and the golden suite key on it too."""
    if isinstance(value, np.ndarray):
        value = value.tolist()
    if isinstance(value, (list, tuple)):
        return tuple(hashable_label(v) for v in value)
    if isinstance(value, np.generic):
        return value.item()
    return value


def cell_overrides(axis: str, value) -> dict:
    """The SimConfig field overrides one axis value denotes."""
    if isinstance(value, Mapping):
        return {k: hashable_label(v) for k, v in value.items()}
    return {axis: hashable_label(value)}


def cell_label(axis: str, value):
    """The hashable grid key / record label of one axis value (for a
    mapping cell: its swept-field entry, else the full override tuple)."""
    if isinstance(value, Mapping):
        if axis in value:
            return hashable_label(value[axis])
        return tuple(sorted((k, hashable_label(v)) for k, v in value.items()))
    return hashable_label(value)


def _sweep_worker(store_root: str, trace: np.ndarray, cfg,
                  chunk_size: Optional[int] = None) -> str:
    """Process-pool job: compute ONE system-key group's sweep and persist
    it to the shared store (the cross-process hand-off).  Module-level so
    the spawn context can pickle it; returns "hit"/"computed" for
    observability.  Workers never ship a SystemTrace back — the parent's
    serial pass hydrates from the store, which is what makes the
    parallel path bit-identical to the serial one.  Phase 1 is host
    NumPy: the worker's simulator lives on the CPU, so the child never
    initialises CUDA."""
    from repro_torch.cachesim.simulator import Simulator
    from repro_torch.cachesim.store import ArtifactStore
    store = ArtifactStore(store_root)
    trace = np.asarray(trace, dtype=np.uint64)
    digest = ArtifactStore.trace_digest(trace)
    key = SystemTrace.system_key(cfg)
    if store.has_sweep(digest, key):
        return "hit"
    st = SystemTrace.compute(Simulator(cfg, device="cpu"), trace,
                             chunk_size=chunk_size)
    store.save_sweep(st, trace_digest=digest)
    return "computed"


def _farm_sweeps(jobs, store, workers: int,
                 chunk_size: Optional[int] = None) -> None:
    """Run the phase-1 sweep jobs ``[(trace, cfg)]`` across a spawn-based
    process pool, persisting each into ``store``.  spawn (not fork): the
    parent may hold a live CUDA context, which a forked child cannot use;
    workers only run the NumPy sweep phase anyway."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    ctx = multiprocessing.get_context("spawn")
    root = str(store.root)
    with ProcessPoolExecutor(max_workers=min(workers, len(jobs)),
                             mp_context=ctx) as pool:
        futs = [pool.submit(_sweep_worker, root, trace, cfg, chunk_size)
                for trace, cfg in jobs]
        for f in futs:
            f.result()      # propagate worker failures loudly


def run_grid(traces: Union[Mapping[str, np.ndarray], Sequence[str]],
             base: SimConfig,
             axis: str,
             values: Sequence,
             policies: Sequence[str] = DEFAULT_POLICIES,
             n_requests: int = 100_000,
             share_system: bool = True,
             device: DeviceLike = None,
             mesh=None,
             store=None,
             workers: int = 0,
             chunk_size: Optional[int] = None,
             report=None,
             ) -> Dict[CellKey, Dict[str, SimResult]]:
    """Run a policy grid over an arbitrary system axis; returns
    ``{(trace_name, label): {policy: SimResult}}``.

    ``traces`` is either a mapping of name -> request array, or a
    sequence of :func:`~repro_torch.cachesim.traces.get_trace` names
    generated at ``n_requests`` with ``base.seed``.  ``share_system=False`` forces
    per-policy full runs (benchmarking the amortisation itself).

    ``store`` (an ``ArtifactStore``, a root path, or None) persists and
    reuses sweeps/tables content-addressed on (trace bytes x system key)
    — see ``repro_torch.cachesim.store``.  ``workers=N`` (N > 1) additionally
    computes the independent system-key groups' sweeps in an N-process
    spawn pool first, handing them off through the store (a temporary
    one when none is given); the subsequent serial pass then runs warm,
    so results are bit-identical to ``workers=0``.

    ``device`` (``None`` -> ``cuda``, raising without a GPU) is where
    every group's decision tables are built and replayed; see
    :func:`repro_torch.cachesim.engine.run_cells`.  ``mesh`` (a 1-D
    ``DeviceMesh``; None makes the sweep mesh when the process world has
    more than one rank, as the reference does with its devices) shards
    the DS_PGM stacked build's cell axis over the ranks; every rank runs
    the grid and gets every result, bit-identical to ``mesh=None``.

    ``chunk_size`` streams every phase-1 sweep (serial and farmed)
    through fixed-size trace slices — bit-identical results, bounded
    sweep working set (see ``SystemTrace.compute``).

    ``report`` (an optional ``repro_torch.cachesim.engine.RunReport``)
    receives the phase times of a flat grid, summed over its groups.
    """
    from repro_torch.cachesim.engine import plan_for, resolve_mesh, run_cells
    from repro_torch.cachesim.store import as_store
    from repro_torch.cachesim.topology import TopoConfig, run_topo_grid
    mesh = resolve_mesh(mesh)
    device = resolve_device(device)
    if not isinstance(traces, Mapping):
        traces = {name: get_trace(name, n_requests, seed=base.seed)
                  for name in traces}
    if isinstance(base, TopoConfig):
        # hierarchical grids (repro_torch.cachesim.topology): topology
        # axes (depth, fanout, per-tier penalty/cadence/queue knobs) or
        # SimConfig axes broadcast through the shared base; per-tier
        # sweeps are shared across cells (and depths) through one
        # store-backed pool.  ``workers`` does not apply — per-tier grids
        # prefetch nothing batched yet.
        return run_topo_grid(traces, base, axis, values,
                             policies=policies,
                             share_system=share_system, store=store,
                             chunk_size=chunk_size, device=device)
    # classify cells by the policy-independent system key: cells of a
    # decision-side axis all share one key (and thus ONE SystemTrace
    # per trace); system-side cells each form their own group
    per_trace: List[Tuple[str, np.ndarray, List[CellKey], Dict]] = []
    for name, trace in traces.items():
        order: List[CellKey] = []
        groups: Dict[tuple, List[Tuple[CellKey, SimConfig]]] = {}
        for value in values:
            key = (name, cell_label(axis, value))
            if key in order:
                raise ValueError(
                    f"duplicate grid cell {key!r}: two axis values share "
                    f"the label {key[1]!r} — give mapping cells distinct "
                    f"{axis!r} entries (or sweep a different axis)")
            order.append(key)
            cfg = dataclasses.replace(base, **cell_overrides(axis, value))
            groups.setdefault(SystemTrace.system_key(cfg),
                              []).append((key, cfg))
        per_trace.append((name, trace, order, groups))

    store = as_store(store)
    tmp_root = None
    try:
        if workers > 1 and share_system:
            if store is None:
                # the hand-off needs SOME shared medium; scope it to the call
                tmp_root = tempfile.mkdtemp(prefix="repro-store-")
                store = as_store(tmp_root)
            # one phase-1 job per (trace, group) whose sweep the serial
            # pass below would compute and that isn't already stored
            jobs = []
            for name, trace, _, groups in per_trace:
                tr = np.asarray(trace, dtype=np.uint64)
                digest = store.trace_digest(tr)
                for sys_key, cells in groups.items():
                    cfgs = [cfg for _, cfg in cells]
                    sweepable = all(cfg.engine == "fast" for cfg in cfgs) \
                        and tr.shape[0] > 0 and any(
                            plan_for(dataclasses.replace(cfg, policy=p))
                            is not None for cfg in cfgs for p in policies)
                    if sweepable and not store.has_sweep(digest, sys_key):
                        jobs.append((tr, cfgs[0]))
            if len(jobs) > 1:   # a 1-job farm is just spawn overhead
                _farm_sweeps(jobs, store, workers, chunk_size=chunk_size)

        out: Dict[CellKey, Dict[str, SimResult]] = {}
        for name, trace, order, groups in per_trace:
            results: Dict[CellKey, Dict[str, SimResult]] = {}
            for cells in groups.values():
                group_out = run_cells(trace, [cfg for _, cfg in cells],
                                      policies, share_system=share_system,
                                      device=device, mesh=mesh, store=store,
                                      chunk_size=chunk_size, report=report)
                for (key, _), cell_res in zip(cells, group_out):
                    results[key] = cell_res
            for key in order:       # keep the caller's cell order
                out[key] = results[key]
        return out
    finally:
        if tmp_root is not None:
            shutil.rmtree(tmp_root, ignore_errors=True)


def run_sweep(traces: Union[Mapping[str, np.ndarray], Sequence[str]],
              base: SimConfig,
              update_intervals: Sequence[int],
              policies: Sequence[str] = DEFAULT_POLICIES,
              n_requests: int = 100_000,
              share_system: bool = True,
              device: DeviceLike = None,
              ) -> Dict[CellKey, Dict[str, SimResult]]:
    """The ``update_interval`` grid (paper Figs. 4-6 x-axis) on ``device``
    (``None`` -> ``cuda``); see :func:`run_grid`."""
    values = [int(i) for i in update_intervals]
    return run_grid(traces, base, "update_interval", values,
                    policies=policies, n_requests=n_requests,
                    share_system=share_system, device=device)


#: record keys an axis label may never shadow: the per-policy result
#: fields every record carries, plus the trace column and the advert
#: totals (attached as plain attributes by both engines)
_RESERVED_RECORD_KEYS = (frozenset(SimResult(policy="").to_dict()) |
                         {"trace", "advert_events", "advert_bytes"})


def axis_column(axis: str) -> str:
    """The record column an axis is flattened under.  An axis whose name
    collides with a :meth:`SimResult.to_dict` field (e.g. a future
    ``n_requests`` axis vs the ``n`` request counter's sibling fields) or
    with ``trace`` would be silently overwritten by the result dict —
    those are prefixed ``axis_<name>`` instead."""
    return axis if axis not in _RESERVED_RECORD_KEYS else f"axis_{axis}"


def sweep_records(grid: Dict[CellKey, Dict[str, SimResult]],
                  axis: str = "update_interval") -> List[dict]:
    """Flatten a :func:`run_grid`/:func:`run_sweep` grid into one record
    per (trace, cell, policy) — ready for CSV/JSON dumps or plotting.
    Per-cache tuple labels serialise as lists in JSON; the axis lands in
    column :func:`axis_column` (prefixed on a result-field collision)."""
    col = axis_column(axis)
    records = []
    for (name, label), cell in grid.items():
        for policy, res in cell.items():
            rec = {"trace": name, col: label}
            rec.update(res.to_dict())
            if hasattr(res, "advert_events"):
                rec["advert_events"] = int(res.advert_events)
                rec["advert_bytes"] = round(float(res.advert_bytes), 2)
            records.append(rec)
    return records
