"""Tensor parallelism over the mesh's ``model`` axis for every model
path that runs on the parameters' shards — ``loss`` (the train step),
``prefill`` and ``decode_step`` of every family: the collectives, their
backward, and the products built on them.

Why a module beside ``distributed.sharding``: that module lays trees out
and gathers them back (the rule tables, DTensor placements, ZeRO-1
blocks, the whole-parameter gathers of ``forward`` and checkpoints);
this one computes on the parameters' local shards, as the reference's
GSPMD partitions the products from the same specs
(``src/repro/distributed/sharding.py``).

The backward keeps one invariant: a replicated activation's gradient is
whole and equal on every model rank.  So each collective's backward is
its transpose (``torch.autograd.Function``s over the same process-group
calls): :func:`gather` (a column gather whose consumer is replicated)
takes the rank's slice; :func:`gather_seq` (the sequence gathered for
rank-partial products) reduce-scatters their partial gradients in
float32; :func:`sum_f32` (the row-parallel all-reduce) is the identity;
:func:`scatter_seq` all-gathers over the sequence; :func:`block` (the
rank's block of a replicated tensor) all-gathers the blocks' gradients.
Where a replicated tensor enters rank-partial products without a
sequence gather — Megatron's "f": the columns of :func:`cols`, the
cross-attention's encoder states, the loss head's input, the SSM's B and
C read by the rank's heads — :func:`sum_grad` all-reduces its gradient in
float32; it also sums the gradient of a replicated parameter used on the
rank's sequence block (the norms under sequence parallelism), so that
every replicated leaf reaches the optimizer with its whole gradient.
Without a recorded gradient each function is the plain forward it was.

The layout decides, leaf by leaf.  :func:`part` reads a parameter's
placements: a DTensor cut over ``model`` gives its local block and the
dim it is cut along; a leaf the rules left replicated (its dim does not
divide, the reference's ``_validate``) or a plain tensor is whole.  The
products then take the path the leaf's layout allows:

  * :func:`cols` / :func:`col` — column-parallel products (``wq``/``wk``/
    ``wv``, ``wg``/``wi``, ``in_proj``) of one input: the rank's
    columns; :func:`col_full` all-gathers them, which is exact (each
    column is one whole dot product);
  * :func:`row` — a row-parallel product (``wo``, ``out_proj``): the
    rank's rows times its block of the input's last dim, the partial
    sums written in float32 (a bf16 GEMM's too), all-reduced in float32
    and rounded once to the compute type (:func:`sum_f32`), or, with the
    residual sequence-parallel, reduce-scattered over the sequence in
    float32 (:func:`scatter_seq`);
  * :func:`embed` — the vocab-parallel lookup: a table cut over its rows
    (a tied embedding, ``("model", None)``) looks up the rank's rows and
    zeroes the others, then all-reduces (exact: one rank contributes each
    row); a table cut over its columns (untied, ``(None, "model")``)
    looks up its columns and all-gathers them;
  * :func:`logits` — the serving head: a head cut over the vocabulary
    gives the rank's logits, all-gathered in float32 to ``[..., V]``
    (the loss never gathers them: ``models.transformer.chunked_ce_loss``
    reduces the softmax over the ranks' blocks).

Sequence parallelism (:func:`seq_axis`) follows the reference's
``shard_activation`` (``sharding.py:59-69``): with mesh rules installed
(``sharding.activation_rules``), ``rules.seq_parallel`` set and the
sequence a multiple of the model axis (more than one token), the
residual between blocks is the rank's ``S / model`` tokens; the blocks
all-gather the normed sequence (:func:`gather_seq`) before their
column-parallel products and reduce-scatter after their row-parallel
ones.  Without rules and with plain parameters every function here is
the plain operation it replaces, in the same order, so a model off the
mesh computes bit for bit as before.

Every collective is an explicit ``torch.distributed`` call on the model
dim's process group: DTensor's own redistribution fails over gloo on
CUDA tensors.  Two-byte floats travel as their bytes (``uint8``) in the
all-gathers: gloo carries every backend's bytes, where it refuses
``int16``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shd

F32 = torch.float32


class Axis(NamedTuple):
    """The mesh's model axis as this rank sees it."""
    group: object
    size: int
    rank: int


def _model_name() -> str:
    rules = shd.current_rules()
    return "model" if rules is None else rules.model_axis


def mesh_axis(mesh, name: Optional[str] = None) -> Optional[Axis]:
    """The model axis of ``mesh`` (None when it has none or one rank)."""
    name = name or _model_name()
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    i = mesh.mesh_dim_names.index(name)
    if mesh.size(i) == 1:
        return None
    return Axis(mesh.get_group(i), mesh.size(i), mesh.get_local_rank(i))


def axis_of(*leaves) -> Optional[Axis]:
    """The model axis of the first DTensor among ``leaves`` (None if none
    is one, or their mesh has no model axis of more than one rank)."""
    from torch.distributed.tensor import DTensor
    for w in leaves:
        if isinstance(w, DTensor):
            return mesh_axis(w.device_mesh)
    return None


def part(w) -> Tuple[torch.Tensor, Optional[int], Optional[Axis]]:
    """(local, dim, axis) of parameter ``w``: the rank's block of it, the
    tensor dim cut over the model axis (None when the rank holds it
    whole) and that axis.  A plain tensor is whole.  The rules cut
    parameters over ``model`` only; a DTensor cut over another mesh dim
    is refused."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(w, DTensor):
        return w, None, None
    mesh, pl = w.device_mesh, tuple(w.placements)
    name = _model_name()
    mi = mesh.mesh_dim_names.index(name) \
        if name in mesh.mesh_dim_names else None
    if any(i != mi for i, _ in shd._sharded(mesh, pl)):
        raise ValueError(f"a parameter cut over another mesh dim than "
                         f"{name!r} ({pl}): lay parameters out by "
                         f"sharding.param_shardings")
    ax = mesh_axis(mesh, name)
    if ax is None or not isinstance(pl[mi], Shard):
        return w.to_local(), None, ax
    return w.to_local(), pl[mi].dim % w.dim(), ax


def block(t: torch.Tensor, dim: int, ax: Optional[Axis]) -> torch.Tensor:
    """The rank's contiguous block of ``t`` along ``dim`` (all of it when
    ``ax`` is None); nothing is sent.  ``t`` is replicated, so the
    backward all-gathers the blocks' gradients (each rank computed on its
    own block)."""
    if ax is None:
        return t
    return _Block.apply(t, dim % t.dim(), ax) if _grad(t) else \
        _narrow(t, dim, ax)


# ---------------------------------------------------------------------------
# the collectives and their backward
# ---------------------------------------------------------------------------

def _grad(t: torch.Tensor) -> bool:
    """Whether autograd records an operation on ``t``."""
    return torch.is_grad_enabled() and t.requires_grad


def _all_gather(t: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order (two-byte
    floats sent as their bytes)."""
    dim = dim % t.dim()
    x = t.movedim(dim, 0).contiguous()
    flat = x.reshape(-1)
    wire = flat.view(torch.uint8) if x.element_size() == 2 and \
        x.is_floating_point() else flat
    out = wire.new_empty(ax.size * wire.numel())
    dist.all_gather_into_tensor(out, wire, group=ax.group)
    out = out.view(x.dtype).view((ax.size * x.shape[0],) + x.shape[1:])
    return out.movedim(0, dim).contiguous()


def _all_reduce_f32(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The ranks' ``t`` summed in float32, rounded once to ``t``'s type."""
    y = t.to(F32).contiguous()
    dist.all_reduce(y, group=ax.group)
    return y.to(t.dtype)


def _reduce_scatter_f32(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The ranks' ``t`` [B, S, ...] summed in float32, this rank's block
    of dim 1, rounded once to ``t``'s type."""
    x = t.to(F32).movedim(1, 0).contiguous()
    out = x.new_empty((x.shape[0] // ax.size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=ax.group)
    return out.movedim(0, 1).to(t.dtype).contiguous()


def _narrow(t: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    n = t.shape[dim] // ax.size
    return t.narrow(dim, ax.rank * n, n)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim``; backward: the rank's slice of the
    gradient, which the consumers of a replicated activation give whole
    and equal on every rank."""

    @staticmethod
    def forward(ctx, t, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _all_gather(t, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _narrow(g, ctx.dim, ctx.ax).contiguous(), None, None


class _GatherSeq(torch.autograd.Function):
    """All-gather of the sequence (dim 1) whose consumers are rank-partial
    products; backward: their partial gradients summed in float32 and
    reduce-scattered over the sequence."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return _all_gather(t, 1, ax)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_f32(g, ctx.ax), None


class _SumF32(torch.autograd.Function):
    """The float32 all-reduce of rank-partial sums; backward: the
    identity (the replicated sum's gradient is whole on every rank)."""

    @staticmethod
    def forward(ctx, t, ax):
        return _all_reduce_f32(t, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterSeq(torch.autograd.Function):
    """The float32 reduce-scatter of rank-partial sums over the sequence;
    backward: the all-gather of the blocks' gradients."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return _reduce_scatter_f32(t, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 1, ctx.ax), None


class _Block(torch.autograd.Function):
    """The rank's block of a replicated tensor; backward: the all-gather
    of the blocks' gradients (each rank computed on its own block)."""

    @staticmethod
    def forward(ctx, t, dim, ax):
        ctx.dim, ctx.ax = dim, ax
        return _narrow(t, dim, ax).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.ax), None, None


class _SumGrad(torch.autograd.Function):
    """The identity; backward: the gradient summed over the model axis in
    float32 (Megatron's "f": a replicated tensor that rank-partial
    products consume, or a replicated parameter used on a sequence
    block)."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_f32(g, ctx.ax), None


class _Own(torch.autograd.Function):
    """The identity; backward: the gradient outside the rank's block of
    the sequence zeroed, so that a whole product's gradient on a gathered
    sequence is counted once by :func:`gather_seq`'s reduce-scatter."""

    @staticmethod
    def forward(ctx, t, ax):
        ctx.ax = ax
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[1] // ctx.ax.size
        keep = torch.zeros_like(g)
        lo = ctx.ax.rank * n
        keep[:, lo:lo + n] = g[:, lo:lo + n]
        return keep, None


def gather(t: torch.Tensor, dim: int, ax: Optional[Axis]) -> torch.Tensor:
    """The ranks' blocks of ``t`` concatenated along ``dim`` in rank order
    (an all-gather over the model axis; ``t`` as it is when ``ax`` is
    None).  Its backward takes the rank's slice of the gradient: the
    result is a replicated activation, whose gradient is whole and equal
    on every rank."""
    if ax is None:
        return t
    if _grad(t):
        return _Gather.apply(t, dim % t.dim(), ax)
    return _all_gather(t, dim, ax)


def sum_f32(t: torch.Tensor, ax: Optional[Axis]) -> torch.Tensor:
    """The sum of the ranks' ``t`` taken in float32 and rounded once to
    ``t``'s type (an all-reduce over the model axis; backward: the
    identity)."""
    if ax is None:
        return t
    return _SumF32.apply(t, ax) if _grad(t) else _all_reduce_f32(t, ax)


def scatter_seq(t: torch.Tensor, ax: Axis) -> torch.Tensor:
    """The sum of the ranks' ``t`` [B, S, ...] in float32, the rank's block
    of the sequence (dim 1) of it, rounded once to ``t``'s type (a
    reduce-scatter over the model axis; backward: an all-gather over the
    sequence)."""
    return _ScatterSeq.apply(t, ax) if _grad(t) else \
        _reduce_scatter_f32(t, ax)


def sum_grad(t, ax: Optional[Axis]):
    """``t`` whose gradient is summed over the model axis in float32 (the
    identity when ``ax`` is None or nothing records a gradient): a
    replicated tensor entering rank-partial products, or a replicated
    parameter used on the rank's block of the sequence."""
    if ax is None or not _grad(t):
        return t
    return _SumGrad.apply(t, ax)


def own(t: torch.Tensor, sp: Optional[Axis]) -> torch.Tensor:
    """``t``, the whole sequence gathered by :func:`gather_seq`, for a
    product that computes it whole: its gradient kept on the rank's block
    of the sequence alone (the identity without ``sp``)."""
    if sp is None or not _grad(t):
        return t
    return _Own.apply(t, sp)


def gather_seq(x: torch.Tensor, sp: Optional[Axis]) -> torch.Tensor:
    """The whole sequence of a sequence-parallel ``x`` [B, S/m, ...], for
    rank-partial products (:func:`cols` with ``sp``): its backward sums
    their partial gradients in float32 and reduce-scatters them over the
    sequence."""
    if sp is None:
        return x
    return _GatherSeq.apply(x, sp) if _grad(x) else _all_gather(x, 1, sp)


def last_token(x: torch.Tensor, sp: Optional[Axis]) -> torch.Tensor:
    """``x[:, -1:]`` of the whole sequence: under sequence parallelism the
    last rank's last token (each rank's last token all-gathered)."""
    if sp is None:
        return x[:, -1:]
    return gather(x[:, -1:], 1, sp)[:, -1:]


def seq_axis(s: int) -> Optional[Axis]:
    """The model axis when the residual of an ``s``-token sequence is
    laid out sequence-parallel: rules installed with ``seq_parallel``,
    ``s > 1`` and ``s`` a multiple of the model axis (the reference's
    ``shard_activation``); else None."""
    rules = shd.current_rules()
    if rules is None or not rules.seq_parallel or s <= 1:
        return None
    ax = mesh_axis(rules.mesh, rules.model_axis)
    return ax if ax is not None and s % ax.size == 0 else None


# ---------------------------------------------------------------------------
# products
# ---------------------------------------------------------------------------

def cols(x: torch.Tensor, ws, sp: Optional[Axis] = None) -> list:
    """``[(x @ w, axis) for w in ws]`` for column-parallel weights [in,
    out]: the rank's columns and the axis where ``w`` is cut over its
    columns, else the whole product and None.

    The backward: a column block's input gradient is the rank's partial
    sum.  With ``sp`` (``x`` the whole sequence from :func:`gather_seq`)
    that reduce-scatter sums it, and a whole product's gradient is kept
    on the rank's block of the sequence (:func:`own`); without, ``x``
    enters the cut products through one float32 all-reduce of their
    gradient (:func:`sum_grad`), the whole products as it is."""
    parts = [part(w) for w in ws]
    ax = next((a for _, d, a in parts if d == 1), None)
    x_cut = x if sp is not None else sum_grad(x, ax)
    x_whole = own(x, sp) if any(d != 1 for _, d, _ in parts) else x
    return [(x_cut @ wl.to(x.dtype), a) if d == 1 else
            (x_whole @ wl.to(x.dtype), None) for wl, d, a in parts]


def col(x: torch.Tensor, w, sp: Optional[Axis] = None
        ) -> Tuple[torch.Tensor, Optional[Axis]]:
    """``x @ w`` for a column-parallel ``w`` [in, out] (:func:`cols`)."""
    return cols(x, (w,), sp)[0]


def col_full(x: torch.Tensor, w, sp: Optional[Axis] = None) -> torch.Tensor:
    """``x @ w`` whole: a column-parallel product's columns gathered."""
    y, ax = col(x, w, sp)
    return gather(y, -1, ax)


def _mm_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` of two-byte ``h`` and ``w``, written in float32: one GEMM
    with a float32 output."""
    y = torch.mm(h.reshape(-1, h.shape[-1]), w, out_dtype=F32)
    return y.view(h.shape[:-1] + (w.shape[-1],))


class _PartialMM(torch.autograd.Function):
    """:func:`_mm_f32`; backward: the gradient (whole, its values those of
    the two-byte output it was rounded from) in ``h``'s type, the input
    and weight gradients two-byte products as one device's are."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        return _mm_f32(h, w)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g = g.to(h.dtype)
        dh = g @ w.T if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:
            dw = h.reshape(-1, h.shape[-1]).T @ g.reshape(-1, g.shape[-1])
        return dh, dw


def _partial(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` as this rank's float32 partial sums: a two-byte ``h``
    times ``w`` in ``h``'s type, its products accumulated and written in
    float32 (on the card one bf16 GEMM with a float32 output; the CPU
    has no such product and multiplies the operands upcast, exact for
    two-byte floats), so that the sum over the ranks rounds once to
    ``h``'s type, as one device's bf16 product does; rounding each
    rank's partial sum first would round twice."""
    w = w.to(h.dtype)
    if not (h.element_size() == 2 and h.is_floating_point()):
        return h @ w
    if h.device.type == "cpu":
        return h.to(F32) @ w.to(F32)
    if _grad(h) or _grad(w):
        return _PartialMM.apply(h, w)
    return _mm_f32(h, w)


def row(h: torch.Tensor, w, h_ax: Optional[Axis] = None,
        sp: Optional[Axis] = None) -> torch.Tensor:
    """``h @ w`` for a row-parallel ``w`` [in, out]; ``h`` is the rank's
    block of its last dim when ``h_ax`` is given, else whole.  ``w`` cut
    over its rows: the rank's block of ``h`` times its rows, summed over
    the ranks in float32 — all-reduced, or with ``sp`` reduce-scattered
    over the sequence.  ``w`` whole: ``h`` gathered, the whole product
    (its sequence block with ``sp``)."""
    wl, dim, ax = part(w)
    if dim == 0:
        if h_ax is None:
            h = block(h, -1, ax)
        y = _partial(h, wl)
        y = scatter_seq(y, ax) if sp is not None else sum_f32(y, ax)
        return y.to(h.dtype)
    y = gather(h, -1, h_ax) @ wl.to(h.dtype)
    return block(y, 1, sp).contiguous() if sp is not None else y


def embed(w, tokens: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """``w[tokens]`` in ``cdt``, vocab-parallel where ``w`` is cut."""
    wl, dim, ax = part(w)
    if dim is None:
        return wl[tokens].to(cdt)
    if dim == 1:
        return gather(wl[tokens], -1, ax).to(cdt)
    n = wl.shape[0]
    idx = tokens - ax.rank * n
    mine = (idx >= 0) & (idx < n)
    rows = wl[idx.clamp(0, n - 1)].to(F32)
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return sum_f32(rows, ax).to(cdt)


def logits(x: torch.Tensor, w, vocab_dim: int) -> torch.Tensor:
    """``(x @ head).to(float32)``, ``head`` being ``w`` (``vocab_dim`` 1:
    an unembedding [d, V]) or ``w.T`` (``vocab_dim`` 0: a tied embedding
    [V, d]).  Cut over the vocabulary: the rank's logits, all-gathered in
    float32; cut over ``d``: a row-parallel product."""
    wl, dim, ax = part(w)
    head = wl.T if vocab_dim == 0 else wl
    if dim is None:
        return (x @ head.to(x.dtype)).to(F32)
    if dim == vocab_dim:
        return gather((x @ head.to(x.dtype)).to(F32), -1, ax)
    return sum_f32(_partial(block(x, -1, ax), head), ax).to(x.dtype).to(F32)


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def localize(tree):
    """``tree`` with every DTensor that this rank holds whole (cut over no
    mesh dim of more than one rank: a replicated norm, router or
    projection) as its local tensor, nothing sent; the leaves cut over
    the model axis stay DTensors, whose placements :func:`part` reads."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_map

    def one(x):
        if isinstance(x, DTensor) and not shd._sharded(x.device_mesh,
                                                       x.placements):
            return x.to_local()
        return x
    return tree_map(one, tree)


def mesh_of(tree):
    """The device mesh of the first DTensor leaf of ``tree`` (None when
    it has none)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import tree_leaves
    return next((x.device_mesh for x in tree_leaves(tree)
                 if isinstance(x, DTensor)), None)


def lay_cache(t: torch.Tensor, mesh, dim: int, whole: int):
    """A prefill's stacked cache leaf ``t`` [L, B, ...] as this rank
    computed it, laid out on ``mesh`` as ``launch.specs.cache_shardings``
    lays the SSM state and conv history out: ``dim`` over the model axis
    where the rank computed its block of it (not ``whole``), and, when
    the batch holds more than one sequence, the batch over the data
    axes — the rank's rows where the rules say the activations are
    them, else its block of the whole batch, kept with nothing sent.
    ``t`` itself off a mesh or where the rank holds it all."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if mesh is None:
        return t
    rules = shd.current_rules()
    model = _model_name()
    names = mesh.mesh_dim_names
    daxes = rules.data_axes if rules is not None else \
        tuple(n for n in names if n != model)
    rows = rules is not None and rules.local_batch
    n_data = 1
    for i, name in enumerate(names):
        if name in daxes:
            n_data *= mesh.size(i)
    cut_batch = t.shape[1] * (n_data if rows else 1) > 1
    pl = [Shard(dim) if name == model and t.shape[dim] != whole else
          Shard(1) if name in daxes and cut_batch else Replicate()
          for name in names]
    if not shd._sharded(mesh, pl):
        return t
    if not rows:
        t = shd.local_slice(t, mesh, [p if p == Shard(1) else Replicate()
                                      for p in pl])
    shape = list(t.shape)
    for i, d in shd._sharded(mesh, pl):
        shape[d] *= mesh.size(i)
    full = torch.empty(shape, device="meta")
    return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False,
                              shape=full.shape, stride=full.stride())
