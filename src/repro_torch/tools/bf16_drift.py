"""How far do a served model's bf16 logits move between the card, the
CPU, the SSD kernel's plain version and two tensor-parallel ranks — and
how far is each from the same weights computed in float32?

For each ``--arch`` (its published config, bf16 weights drawn on the
card from ``--seed``, batch 2): a ``--prompt``-token prefill and
``--steps`` decode steps, every run fed the tokens that the first one
chose greedily.  The runs:

  card          bf16 compute on the card, through the kernels
  card_exact    as ``card`` with cuBLAS's reduced-precision bf16
                reductions turned off
                (``allow_bf16_reduced_precision_reduction``)
  card_plain    as ``card`` with the SSD kernel's plain version in its
                place (models with SSM blocks)
  cpu           bf16 on the CPU (the kernels' plain versions)
  f32           the same bf16 weights computed in float32 on the card:
                the witness the others are measured from
  tp            bf16 tensor-parallel over two gloo ranks of the card on a
                ``(data 1, model 2)`` mesh (``--tp``)

For every run and step it prints the largest |difference| over the
batch and the vocabulary as a share of the largest |logit| of the
reference, against ``card`` and against ``f32`` (step 0 is the
prefill's last token):

  PYTHONPATH=src python -m repro_torch.tools.bf16_drift \\
      --arch mamba2-370m --arch smollm-135m --tp --out build/drift.json

needs a card, prints one ``[bf16_drift] {...}`` JSON line an arch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import torch

F32 = torch.float32


def _weights(cfg, seed: int, prompt_len: int):
    from repro_torch.models import init_params
    params = init_params(cfg, torch.Generator("cuda").manual_seed(seed),
                         "cuda")
    prompt = torch.randint(0, cfg.vocab, (2, prompt_len), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(
                               seed + 1))
    return params, prompt


def serve(cfg, params, prompt, steps: int, toks=None, mesh=None):
    """(logits [steps + 1, B, V] float32 on the CPU, tokens fed): the
    prefill and ``steps`` decode steps of ``cfg``'s model, greedy when
    ``toks`` is None, tensor-parallel when ``mesh`` is given."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs as S
    from repro_torch.models import get_model
    model = get_model(cfg)
    shape = ShapeConfig("drift", prompt.shape[1] + steps, prompt.shape[0],
                        "decode")
    rules = None
    if mesh is not None:
        params = sh.distribute(params, mesh, sh.param_shardings(
            mesh, params, cfg.tie_embeddings))
        rules = S.make_rules(mesh, cfg)
    kw = {} if cfg.family == "ssm" else {"max_len": shape.seq_len}
    out, fed = [], []
    with torch.no_grad(), sh.activation_rules(rules):
        lg, cache = model.prefill(params, {"tokens": prompt}, **kw)
        if mesh is not None:
            cache = S.lay_out(cache, mesh, S.cache_shardings(mesh, cfg,
                                                             cache, shape))
        for i in range(steps):
            out.append(lg.float().cpu())
            tok = lg.argmax(-1) if toks is None else toks[i].to(lg.device)
            fed.append(tok.cpu())
            if mesh is not None:
                tok = S.lay_out(tok, mesh, S.token_shardings(mesh, shape))
            lg, cache = model.decode_step(params, cache, tok)
            lg = sh.full(lg)
        out.append(lg.float().cpu())
    return torch.stack(out), fed


def _tp_world(rank, world, arch, seed, prompt_len, steps, path):
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    params, prompt = _weights(cfg, seed, prompt_len)
    toks = torch.load(path)
    got, _ = serve(cfg, params, prompt, steps, toks,
                   make_mesh((1, 2), ("data", "model")))
    if rank == 0:
        torch.save(got, path + ".tp")


def _shares(got, ref):
    """Per step: max |got - ref| over the batch and vocabulary over the
    largest |ref|."""
    top = float(ref.abs().max())
    return [float((g - r).abs().max()) / top for g, r in zip(got, ref)]


def drift(arch: str, seed: int, prompt_len: int, steps: int,
          tp: bool) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.kernels.ssd.ref import ssd_scan_ref
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    params, prompt = _weights(cfg, seed, prompt_len)
    runs = {}
    runs["card"], toks = serve(cfg, params, prompt, steps)
    mm = torch.backends.cuda.matmul
    flag = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        runs["card_exact"], _ = serve(cfg, params, prompt, steps, toks)
    finally:
        mm.allow_bf16_reduced_precision_reduction = flag
    if cfg.family in ("ssm", "hybrid"):
        kernel = ssm.ssd_scan
        ssm.ssd_scan = lambda *a, **k: ssd_scan_ref(*a, **k)
        try:
            runs["card_plain"], _ = serve(cfg, params, prompt, steps, toks)
        finally:
            ssm.ssd_scan = kernel
    runs["f32"], _ = serve(dataclasses.replace(cfg, dtype="float32"),
                           params, prompt, steps, toks)
    runs["cpu"], _ = serve(cfg, tree_map(lambda t: t.cpu(), params),
                           prompt.cpu(), steps, toks)
    if tp:
        from repro_torch.launch.mesh import run_world
        with tempfile.TemporaryDirectory(dir=".") as tmp:
            path = str(Path(tmp) / "toks.pt")
            torch.save(toks, path)
            run_world(_tp_world, 2, Path(tmp) / "store",
                      args=(arch, seed, prompt_len, steps, path),
                      device="cuda", backend="gloo", timeout=600)
            runs["tp"] = torch.load(path + ".tp")
    return {"arch": arch, "steps": steps, "prompt": prompt_len,
            "card": torch.cuda.get_device_name(0),
            "vs_card": {k: _shares(v, runs["card"]) for k, v in runs.items()
                        if k != "card"},
            "vs_f32": {k: _shares(v, runs["f32"]) for k, v in runs.items()
                       if k != "f32"}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", required=True)
    ap.add_argument("--seed", type=int, default=23)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--tp", action="store_true")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("[bf16_drift] needs a card", file=sys.stderr)
        return 1
    res = []
    for arch in a.arch:
        res.append(drift(arch, a.seed, a.prompt, a.steps, a.tp))
        print("[bf16_drift] " + json.dumps(res[-1]), flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
