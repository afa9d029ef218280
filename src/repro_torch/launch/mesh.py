"""Device meshes of the port — the port of the JAX package's
``repro.launch.mesh``, over a ``torch.distributed`` process world.

JAX runs one controller over every device; the port runs one process a
rank (SPMD), each rank on one device, and a JAX ``Mesh`` becomes a
``torch.distributed.device_mesh.DeviceMesh`` over those ranks with the
same axis names.  Building a mesh is collective: every rank of the world
calls the constructor (a rank outside the mesh gets one whose
``get_coordinate()`` is None).

* :func:`make_production_mesh` — (16, 16) ``("data", "model")`` or
  (2, 16, 16) with ``"pod"``; raises with fewer ranks, as the reference
  raises with fewer devices.
* :func:`make_sweep_mesh` — a 1-D ``("cells",)`` mesh over the world for
  the sweep grid's cell-sharded table build; None at a world of <= 1
  rank, so a single process needs no special casing.
* :func:`init_distributed` / :func:`shutdown_distributed` — start the
  process group from ``torch.distributed.run``'s environment (``RANK``,
  ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``), ``nccl`` for ``cuda``
  and ``gloo`` for ``cpu`` unless a backend is named, and tear it down.
* :func:`fake_world` — a world of N ranks in this one process on
  torch's ``fake`` backend (collectives return without moving data),
  this process rank 0: the dry run's 256 and 512 ranks, which no single
  host has;
* :func:`run_world` — a world of N spawned processes on this host
  meeting at a ``FileStore`` (no port), each running a function; it
  raises, and stops the others, when a rank fails or the deadline
  passes, so a hung rendezvous never hangs the caller.
"""
from __future__ import annotations

import math
import os
import time
from contextlib import contextmanager
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve_device


_DEVICE: Optional[torch.device] = None   # this rank's device, once started
_SWEEP_MESHES: dict = {}                 # (ranks, device type) -> mesh


def world_size() -> int:
    """Ranks of the started process group (1 when none is started)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def mesh_device_type() -> str:
    """The device type of a mesh over this world: that of the device
    :func:`init_distributed` gave this rank; for a group started
    otherwise, ``resolve_device()``'s (``cuda``, raising without a
    GPU)."""
    return (_DEVICE or resolve_device()).type


def init_distributed(device: DeviceLike = None, backend: Optional[str] = None,
                     *, init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world: Optional[int] = None) -> torch.device:
    """Start the default process group and return this rank's device:
    ``cuda`` (card ``LOCAL_RANK``, else the rank, modulo the visible
    cards) unless ``device`` says ``cpu``.  ``backend`` defaults to
    ``nccl`` on ``cuda`` and ``gloo`` on ``cpu``.  Rank and world come
    from the launcher's environment (``RANK``, ``WORLD_SIZE``; a world of
    1 when unset) unless given; the rendezvous is ``init_method``, else
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``), else — a lone process
    — an in-memory store.  A started group is left as it is."""
    global _DEVICE
    dev = resolve_device(device)
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    world = int(os.environ.get("WORLD_SIZE", "1")) if world is None \
        else world
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if init_method is None and "MASTER_ADDR" not in os.environ:
            if world != 1:
                raise RuntimeError(
                    f"a world of {world} ranks needs a rendezvous: run under "
                    f"python -m torch.distributed.run or pass init_method")
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            dist.init_process_group(backend, init_method=init_method or
                                    "env://", rank=rank, world_size=world)
    _DEVICE = dev
    return dev


def shutdown_distributed() -> None:
    """Tear the default process group down (no-op when none is
    started)."""
    global _DEVICE
    if dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE = None
    _SWEEP_MESHES.clear()


def make_mesh(shape, axes, *, device_type: Optional[str] = None,
              ranks=None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over
    ``ranks`` (the first prod(shape) ranks of the world by default).
    Collective: every rank of the world calls it."""
    n = math.prod(shape)
    ids = torch.arange(n) if ranks is None else torch.as_tensor(list(ranks))
    return DeviceMesh(device_type or mesh_device_type(), ids.reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None) -> DeviceMesh:
    """(16, 16) ``("data", "model")``, or (2, 16, 16)
    ``("pod", "data", "model")`` — the second data axis spans the slower
    inter-pod links — over ``device_type`` (:func:`mesh_device_type`'s
    unless named).  Raises with fewer ranks than the mesh needs."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = world_size()
    if have < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks, found {have}; start {n} "
            f"processes (python -m torch.distributed.run --nproc-per-node "
            f"...) before building it")
    return make_mesh(shape, axes, device_type=device_type)


def data_axes(mesh: DeviceMesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def make_sweep_mesh(*, max_devices: Optional[int] = None
                    ) -> Optional[DeviceMesh]:
    """1-D ``("cells",)`` mesh over the world's ranks (the first
    ``max_devices`` of them) for the sweep grid's table builds: decision
    cells are row-sharded along it, the shared view history repeated on
    every rank.  None with <= 1 rank: the sweep then runs the same
    computation unsharded.  Made once per world (every rank calls the
    first one) and reused."""
    n = world_size()
    if max_devices is not None:
        n = min(n, max_devices)
    if n <= 1:
        return None
    key = (n, mesh_device_type())
    if key not in _SWEEP_MESHES:        # one set of groups per world
        _SWEEP_MESHES[key] = make_mesh((n,), ("cells",))
    return _SWEEP_MESHES[key]


@contextmanager
def fake_world(world: int):
    """While open, the default process group is a ``fake`` one of
    ``world`` ranks in this process, which is rank 0: meshes build over
    it, and its collectives return at once without writing their outputs
    (harmless on meta tensors, whose values do not exist; on the card
    they leave the received buffers as allocated).  A mesh over it needs
    its device type named (``make_production_mesh(device_type=...)``).
    Refuses to start over a group already started; tears the group down
    on exit."""
    # importing the module registers the ``fake`` backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already started; the fake "
                           "world needs the default group to itself")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        shutdown_distributed()


def _world_entry(fn, rank: int, world: int, store_path: str, device: str,
                 backend: Optional[str], timeout: float, args) -> None:
    import faulthandler
    # past the deadline, print every thread's stack and exit: a hung
    # collective shows where it waits
    faulthandler.dump_traceback_later(timeout, exit=True)
    torch.set_num_threads(1)
    init_distributed(device, backend, init_method=f"file://{store_path}",
                     rank=rank, world=world)
    try:
        fn(rank, world, *args)
        dist.barrier()
    finally:
        shutdown_distributed()


def run_world(fn: Callable, world: int, store_path, *, args: Sequence = (),
              device: DeviceLike = None, backend: Optional[str] = None,
              timeout: float = 120.0) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes, each
    with the default process group started by :func:`init_distributed` on
    ``device`` (``cuda`` unless the caller names ``cpu``; card ``rank``
    modulo the visible cards unless one is named; ``backend``: ``nccl``
    on ``cuda``, ``gloo`` on ``cpu`` unless named) through a
    ``FileStore`` at ``store_path`` (a new file).  ``fn`` must be
    importable (a module-level function).  Raises ``RuntimeError`` —
    after killing the other ranks — when a rank exits non-zero or the
    world has not finished within ``timeout`` seconds (each rank then
    prints its threads' stacks and exits first)."""
    import torch.multiprocessing as mp
    device = str(resolve_device(device))
    store_path = os.path.abspath(store_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_world_entry,
                         args=(fn, r, world, store_path, device,
                               backend, timeout, tuple(args)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout + 10
    try:
        while any(p.is_alive() for p in procs):
            bad = [(r, p.exitcode) for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                raise RuntimeError(f"{fn.__name__}: rank {bad[0][0]} exited "
                                   f"with {bad[0][1]}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"{fn.__name__}: a world of {world} did "
                                   f"not finish within {timeout} s")
            time.sleep(0.05)
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"{fn.__name__}: rank {bad[0][0]} exited "
                               f"with {bad[0][1]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
