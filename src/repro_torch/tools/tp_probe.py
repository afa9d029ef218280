"""Would a tensor-parallel step keep the mesh's 2e-4 parameter gate?

The port's models gather their parameters on a device mesh and compute
replicated (``distributed.sharding``); the reference's GSPMD divides the
products over the ``model`` axis.  This probe measures what dividing them
does to the numbers.  In a world of ``--ranks`` processes (one ``model``
axis over all of them) a dense transformer's blocks run Megatron-style:

* the in-projections (``wq``, ``wk``, ``wv``, ``wg``, ``wi``) are
  column-parallel: each rank multiplies by its columns, and the gradient
  of their input is the all-reduced sum of the ranks' partial products;
* the out-projections (attention's and the MLP's ``wo``) are
  row-parallel: each rank multiplies its slice of the contraction, and
  the output is the all-reduced sum of the ranks' partial products.

Attention's q, k and v columns are all-gathered before the heads, which
every rank computes (the rank count need not divide them), and the
gradient of the heads' output is all-gathered likewise; the embedding, the norms and the loss
head stay replicated, so the probe shows a lower bound of what GSPMD's
partitioning moves.  Partial products are rounded to the compute dtype
before the sum; the sum itself runs in float32 and is rounded once.
Rank 0 compares one AdamW step of that with the replicated step from the
same parameters and batch: the loss, the gradient entries whose sign
differs, and the largest parameter difference against the gate.

  PYTHONPATH=src python -m repro_torch.tools.tp_probe --device cpu \\
      --layers 2

prints one ``[tp_probe] {...}`` JSON line per compute dtype.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.nn.functional as F

GATE = 2e-4          # the mesh step's parameter tolerance
SHARDED = ("wq", "wk", "wv", "wo", "wg", "wi")


def _sum_ranks(x: torch.Tensor) -> torch.Tensor:
    y = x.to(torch.float32).contiguous()
    dist.all_reduce(y)
    return y.to(x.dtype)


class _Copy(torch.autograd.Function):
    """Identity; the backward sums the gradient over the ranks."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_ranks(g)


class _Reduce(torch.autograd.Function):
    """The sum over the ranks; the backward is the identity."""

    @staticmethod
    def forward(ctx, x):
        return _sum_ranks(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GatherCols(torch.autograd.Function):
    """The ranks' column blocks concatenated; the backward takes this
    rank's block."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_rank()
        return g[..., r * ctx.n:(r + 1) * ctx.n].contiguous()


class _SliceCols(torch.autograd.Function):
    """This rank's column block; the backward all-gathers the ranks'
    gradient blocks, so that the replicated heads before it see the
    whole gradient."""

    @staticmethod
    def forward(ctx, x):
        return x[..., _block(x.shape[-1])]

    @staticmethod
    def backward(ctx, g):
        return _GatherCols.apply(g)


def _block(n: int) -> slice:
    r, w = dist.get_rank(), dist.get_world_size()
    if n % w:
        raise ValueError(f"{n} columns do not split over {w} ranks")
    return slice(r * n // w, (r + 1) * n // w)


def _attn_tp(p, x, cfg, positions, *, causal=True, kv_override=None):
    """``layers.attn_forward`` with column-parallel q, k, v and a
    row-parallel out-projection."""
    from repro_torch.models import layers as L
    if kv_override is not None:
        raise ValueError("the probe runs self attention only")
    b, s, _ = x.shape
    xf = _Copy.apply(x)

    def col(w):
        w = w.to(x.dtype)
        return _GatherCols.apply(xf @ w[:, _block(w.shape[1])])
    q = col(p["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = col(p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = col(p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    if cfg.attn_mode == "naive":
        o = L.attention_naive(q, k, v, causal=causal)
    else:
        o = L.attention_chunked(q, k, v, causal=causal, chunk=cfg.attn_chunk)
    o = o.reshape(b, s, -1)
    rows = _block(o.shape[-1])
    return _Reduce.apply(_SliceCols.apply(o) @ p["wo"].to(x.dtype)[rows])


def _mlp_tp(p, x, sp=None):
    """``layers.mlp_forward`` with column-parallel ``wg``/``wi`` and a
    row-parallel ``wo`` (the training path: ``sp`` is None)."""
    cdt = x.dtype
    cols = _block(p["wg"].shape[1])
    xf = _Copy.apply(x)
    h = F.silu(xf @ p["wg"].to(cdt)[:, cols]) * (xf @ p["wi"].to(cdt)[:, cols])
    return _Reduce.apply(h @ p["wo"].to(cdt)[cols])


def _step(model, params, batch, ocfg, tp: bool):
    """(loss, grads, new params) of one AdamW step from ``params``; with
    ``tp`` under the tensor-parallel blocks, whose sharded leaves'
    gradients are nonzero on this rank's block only, so that summing them
    over the ranks assembles the full gradient exactly."""
    from repro_torch.models import layers as L
    from repro_torch.optim import (apply_updates, init_train_state,
                                   loss_and_grads)
    from repro_torch.tree import tree_paths
    plain = (L.attn_forward, L.mlp_forward)
    if tp:
        L.attn_forward, L.mlp_forward = _attn_tp, _mlp_tp
    try:
        (loss, _), grads = loss_and_grads(model, params, batch)
    finally:
        L.attn_forward, L.mlp_forward = plain
    if tp:
        for path, g in tree_paths(grads):
            if path[0] == "layers" and path[-1] in SHARDED:
                dist.all_reduce(g)
    state, _ = apply_updates(init_train_state(params, ocfg), grads, ocfg)
    return float(loss), grads, state["params"]


def compare(opts: dict) -> dict:
    """One replicated and one tensor-parallel AdamW step of ``opts``'
    model from the same parameters and batch (every rank calls it, in a
    started process group); rank 0's comparison."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, to_device
    from repro_torch.launch.mesh import mesh_device_type
    from repro_torch.models import get_model, init_params
    from repro_torch.optim import OptConfig
    from repro_torch.tree import tree_paths
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh_device_type() == "cuda" else torch.device("cpu")
    cfg = get_config(opts["arch"])
    if opts["reduced"]:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, n_layers=opts["layers"] or cfg.n_layers,
                              dtype=opts["dtype"], remat="none")
    if cfg.family != "dense":
        raise ValueError("the probe runs the dense family")
    model = get_model(cfg)
    ocfg = OptConfig(lr=opts["lr"],
                     warmup_steps=min(20, opts["steps"] // 5 + 1),
                     total_steps=opts["steps"])
    data = SyntheticLMData(DataConfig(batch=opts["batch"], seq=opts["seq"],
                                      vocab=min(cfg.vocab, 256),
                                      seed=opts["seed"]), model_cfg=cfg)
    batch = to_device(data.batch_at(0), dev)
    params = init_params(cfg, torch.Generator(dev).manual_seed(opts["seed"]),
                         device=dev)
    loss_r, grads_r, new_r = _step(model, params, batch, ocfg, tp=False)
    loss_t, grads_t, new_t = _step(model, params, batch, ocfg, tp=True)
    flips = total = over = 0
    max_diff = 0.0
    for (_, gr), (_, gt), (_, pr), (_, pt) in zip(
            tree_paths(grads_r), tree_paths(grads_t), tree_paths(new_r),
            tree_paths(new_t)):
        flips += int(((gr > 0) != (gt > 0)).logical_and(
            (gr != 0) | (gt != 0)).sum())
        total += gr.numel()
        d = (pr.to(torch.float32) - pt.to(torch.float32)).abs()
        over += int((d > GATE).sum())
        max_diff = max(max_diff, float(d.max()))
    return {"arch": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
            "ranks": dist.get_world_size(), "device": dev.type,
            "batch": opts["batch"], "seq": opts["seq"],
            "loss_replicated": loss_r, "loss_tp": loss_t,
            "loss_rel_diff": abs(loss_t - loss_r) / abs(loss_r),
            "grad_entries": total, "grad_sign_flips": flips,
            "param_max_abs_diff": max_diff, "params_over_gate": over,
            "gate": GATE, "within_gate": max_diff <= GATE}


def _world(rank, world, opts, out):
    rows = []
    for dtype in opts["dtypes"]:
        rows.append(compare({**opts, "dtype": dtype}))
    if rank == 0:
        Path(out).write_text(json.dumps(rows))


def run(opts: dict, device=None, backend=None, timeout=1200.0) -> list:
    """:func:`compare` for each of ``opts["dtypes"]`` in a spawned world of
    ``opts["ranks"]`` ranks on ``device`` (``cuda`` unless named); the
    rows, one a dtype."""
    from repro_torch.launch.mesh import run_world
    with tempfile.TemporaryDirectory() as d:
        out = Path(d) / "rows.json"
        run_world(_world, opts["ranks"], Path(d) / "store",
                  args=(opts, str(out)), device=device, backend=backend,
                  timeout=timeout)
        return json.loads(out.read_text())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="depth cut (0: the config's)")
    ap.add_argument("--dtypes", default="bfloat16,float32")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--steps", type=int, default=5,
                    help="the schedule's length (one step is taken)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None)
    a = ap.parse_args(argv)
    opts = {k: getattr(a, k) for k in ("arch", "reduced", "layers", "ranks",
                                       "batch", "seq", "lr", "steps",
                                       "seed")}
    opts["dtypes"] = a.dtypes.split(",")
    for row in run(opts, a.device, a.backend):
        print(f"[tp_probe] {json.dumps(row)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
