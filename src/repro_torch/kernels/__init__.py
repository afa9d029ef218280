"""Kernels written by hand for Hopper (sm_90a), each beside its plain
PyTorch version; ``ops`` picks one by the device of its inputs.

The kernels are called through ctypes, so no dispatcher sees them.  A
wrapper therefore announces each call with its work (``kernel_call``) to
whatever cost trace is listening (``launch.cost.CostTrace`` registers
itself in ``SINKS`` while active): the card's launch, the CPU's plain
version and the meta device's shape-only path all report the same
FLOPs and bytes, and the plain version's own operations are not counted
twice.

Each kernel module counts its card launches in a dict of its own
(``LAUNCHES``), made by :func:`launch_counter` and so listed in
``LAUNCH_COUNTERS``: a CUDA graph that replays a captured step
(``models.decode_graph``) launches no kernel through the wrappers, and
adds to every listed counter what its capture counted.
"""
from contextlib import contextmanager

import torch

#: listeners of kernel calls: objects with ``kernel_enter(name, flops,
#: nbytes)`` and ``kernel_exit()``
SINKS: list = []
#: every kernel module's launch counter (its ``LAUNCHES``)
LAUNCH_COUNTERS: list = []


def launch_counter(*names: str) -> dict:
    """A kernel module's ``LAUNCHES``: a count for each of ``names``, 0 to
    start, listed in ``LAUNCH_COUNTERS``."""
    counter = dict.fromkeys(names, 0)
    LAUNCH_COUNTERS.append(counter)
    return counter


@contextmanager
def kernel_call(name: str, flops: float, nbytes: float):
    """Around one call of kernel ``name`` that needs ``flops`` and moves
    ``nbytes`` (each input read once, each output written once)."""
    for sink in SINKS:
        sink.kernel_enter(name, flops, nbytes)
    try:
        yield
    finally:
        for sink in reversed(SINKS):
            sink.kernel_exit()


def refuse_grad(kernel: str, instead: str, tensors) -> None:
    """Raise ``ValueError`` if gradients are enabled and any of
    ``tensors`` requires one: the kernels have no backward, so their
    outputs would carry none and a gradient through them would be
    silently missing.  Raised on every device, the CPU included (where
    the plain version could differentiate), so that CPU tests catch a
    training path that strays onto a kernel."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise ValueError(
            f"{kernel} has no backward (the kernel's output carries no "
            f"gradient); differentiate through {instead} instead, or call "
            f"it under torch.no_grad()")
