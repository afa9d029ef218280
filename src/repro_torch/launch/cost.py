"""A cost trace of one step of the port — the counterpart of the JAX
package's ``repro.launch.hlo_cost``, which re-derives roofline inputs
from compiled HLO text.

The port has no HLO.  :class:`CostTrace` is a ``TorchDispatchMode``: the
step runs under it (on the meta device for the dry run, which computes
no value, or on the card) and every aten and c10d operation it
dispatches is counted as it passes:

  * FLOPs            — every matrix product (``mm``, ``addmm``, ``bmm``,
                       ``baddbmm``, ``mv``, ``addmv``, ``dot``): 2 x
                       numel(result) x the contracted size — what
                       ``hlo_cost`` counts for a ``dot`` — plus the work
                       the hand-written kernels report for each call
                       (``kernels.kernel_call``: ``flash_work``,
                       ``ssd_work``), which no dispatcher sees;
  * HBM bytes        — per operation that materialises: result plus
                       operand bytes (views, ``empty`` and the like are
                       free), plus the kernels' reported bytes;
  * collective bytes — operand bytes of every all-gather, all-reduce,
                       reduce-scatter, all-to-all and send/recv (counted
                       as collective-permute), also added to HBM bytes as
                       ``hlo_cost`` adds them: the bytes each call sends,
                       as the port issues its calls — one a mesh dim, so a
                       reduction over ``("pod", "data")`` counts a call
                       over each (a reduce-scatter its whole input, then
                       the half left), where XLA may issue one;
  * live bytes       — every storage an operation allocates, rounded up
                       to the CUDA caching allocator's 512-byte blocks,
                       from its allocation until Python frees it; the
                       peak, above what was live when the trace began, is
                       the step's peak temporaries.  A model of the
                       allocator: it misses what an operation allocates
                       and frees inside itself (library workspaces) and
                       the allocator's segment slack, and it counts the
                       storages a kernel wrapper allocates for its
                       outputs and scratch.

Eager torch dispatches every iteration of every Python loop (layers,
query chunks, loss chunks), so no trip count needs recovering: the
counts are those of the whole step as it ran.

``hlo_cost`` function -> counterpart here:
  * ``analyze(hlo_text)``        -> :meth:`CostTrace.summary` of a step
    run under the trace;
  * ``top_ops(hlo_text, n)``     -> :meth:`CostTrace.top_ops`: bytes per
    aten operation, summed over its calls;
  * ``attribute_bytes(text, pats)`` -> :meth:`CostTrace.attribute_bytes`:
    regexes over the aten operation names.  ``ATTN_SCORE_PAT`` matches
    the softmax forward and backward, which every attention score tensor
    of the port's plain attention passes through (the flash kernel's
    scores never reach memory, so a kernel prefill shows none);
    ``CONVERT_PAT`` matches ``_to_copy``, the dtype conversions;
  * ``parse_module``, ``trip_count``, ``comp_cost`` — HLO text parsing
    and the while-loop nest: no counterpart (see above).
"""
from __future__ import annotations

import re
import weakref
from typing import Callable, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
#: c10d operation -> (collective kind, index of its operand argument)
_C10D = {
    "_allgather_base_": ("all-gather", 1),
    "allgather_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
}
#: matrix products: name -> index of the left operand
_DOTS = {"mm": 0, "bmm": 0, "mv": 0, "dot": 0, "addmm": 1, "baddbmm": 1,
         "addmv": 1}
#: operations that move no data although they are not views
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "lift_fresh", "detach",
         "alias", "_local_scalar_dense"}

ATTN_SCORE_PAT = r"^_softmax(_backward_data)?$"
CONVERT_PAT = r"^_to_copy$"
#: the caching allocator's block granularity
BLOCK = 512


def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors (a DTensor's local shard) in an operation's arguments
    or results: nested tuples, lists and dicts, walked without the
    general pytree machinery, which costs a fifth of a trace."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(_local(x))
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _dot_flops(name: str, args, out) -> float:
    lhs = _local(args[_DOTS[name]])
    k = lhs.shape[-1] if lhs.dim() else 1
    return 2.0 * _local(out).numel() * k


class CostTrace(TorchDispatchMode):
    """Counts one step's FLOPs, bytes, collective bytes, kernel calls and
    live bytes while active (``with CostTrace() as tr: step(...)``)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0
                                              for k in COLLECTIVE_KINDS}
        self.ops = 0
        self.kernel_calls: Dict[str, int] = {}
        self.kernel_flops = 0.0
        self.by_op: Dict[str, List[float]] = {}   # name -> [bytes, flops, n]
        self.live = 0
        self.peak = 0
        self._depth = 0          # inside a kernel call: its ops not counted
        self._storages: Dict[int, Tuple[weakref.ref, int]] = {}

    # ---------------- activation ----------------
    def __enter__(self):
        kernels.SINKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.SINKS.remove(self)
        return super().__exit__(*exc)

    # ---------------- kernels (kernels.kernel_call) ----------------
    def kernel_enter(self, name: str, flops: float, nbytes: float) -> None:
        if self._depth == 0:
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
            self.kernel_flops += flops
            self.flops += flops
            self.bytes += nbytes
            row = self.by_op.setdefault(f"kernel:{name}", [0.0, 0.0, 0])
            row[0] += nbytes
            row[1] += flops
            row[2] += 1
        self._depth += 1

    def kernel_exit(self) -> None:
        self._depth -= 1

    # ---------------- memory model ----------------
    def _track(self, out, inputs) -> None:
        """Start counting the storages of ``out`` that no input holds (a
        view's or an in-place result's storage is its input's)."""
        held = {t.untyped_storage()._cdata for t in _tensors(inputs)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages or key in held:
                continue
            size = -(-st.nbytes() // BLOCK) * BLOCK
            self._storages[key] = (weakref.ref(st, self._freer(key, size)),
                                   size)
            self.live += size
            self.peak = max(self.peak, self.live)

    def _freer(self, key: int, size: int) -> Callable:
        def free(_):
            if self._storages.pop(key, None) is not None:
                self.live -= size
        return free

    # ---------------- dispatch ----------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self._track(out, (args, kwargs))
        if self._depth:
            return out
        self.ops += 1
        name = func._overloadpacket.__name__
        if func.namespace == "c10d":
            kind = _C10D.get(name)
            if kind is not None:
                nbytes = _nbytes(args[kind[1]])
                self.collectives[kind[0]] += nbytes
                self._count(name, nbytes, 0.0)
            return out
        if func.is_view or name in _FREE:
            return out
        flops = _dot_flops(name, args, out) if name in _DOTS else 0.0
        self._count(name, _nbytes(out) + _nbytes((args, kwargs)), flops)
        return out

    def _count(self, name: str, nbytes: float, flops: float) -> None:
        self.bytes += nbytes
        self.flops += flops
        row = self.by_op.setdefault(name, [0.0, 0.0, 0])
        row[0] += nbytes
        row[1] += flops
        row[2] += 1

    # ---------------- reading ----------------
    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    def top_ops(self, n: int = 15) -> List[Tuple[float, str, float, int]]:
        """The ``n`` operations moving the most bytes: (bytes, name,
        flops, calls), summed over their calls."""
        rows = [(b, name, f, int(c)) for name, (b, f, c) in
                self.by_op.items()]
        return sorted(rows, key=lambda r: -r[0])[:n]

    def attribute_bytes(self, patterns: Dict[str, str]) -> Dict[str, float]:
        """For each named regex, the bytes of the operations whose aten
        name matches it (the first pattern that matches takes an
        operation)."""
        regs = {k: re.compile(p) for k, p in patterns.items()}
        res = {k: 0.0 for k in patterns}
        for name, (b, _, _) in self.by_op.items():
            for k, rg in regs.items():
                if rg.search(name):
                    res[k] += b
                    break
        return res

    def summary(self) -> Dict:
        """``hlo_cost.analyze``'s keys, plus the operation count, kernel
        calls and work, and the peak live bytes."""
        attr = self.attribute_bytes({"attention_score": ATTN_SCORE_PAT,
                                     "dtype_convert": CONVERT_PAT})
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": self.collective_bytes,
            "collectives": dict(self.collectives),
            "attn_score_bytes": attr["attention_score"],
            "convert_bytes": attr["dtype_convert"],
            "ops": self.ops,
            "kernel_calls": dict(self.kernel_calls),
            "kernel_flops": self.kernel_flops,
            "peak_live_bytes": self.peak,
        }

