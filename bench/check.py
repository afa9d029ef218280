"""Whether what the timed path produced is correct, by comparison with the
plain references under ``bench/reference`` (which import nothing of the
program and take nothing it made: the benchmark's own weights and
documents go to both sides).

Three numbers, each with a limit of its own (``bench/limits/<cell>.json``):

- ``route_mismatch``: requests, of set-up and window alike, whose nodes
  probed or whose outcome (hit, or a prefill) differ from the reference
  router's replay of the same stream.  Exact: limit 0.
- ``prefill_logit_err``: over the sampled documents' prefills in the
  window, the largest relative L2 distance of ``ServeEngine.prefill``'s
  last-token logits from the reference's float32 logits.
- ``decode_gap``: over the sampled requests' served tokens (greedy, from
  the first token 0 that the launcher feeds), the widest gap by which a
  served token's reference logit lies below the reference's best at its
  position.  ``ServeEngine.decode`` returns tokens only; the reference
  runs one forward pass over the document, the 0 and the served tokens
  but the last, and reads every position's logits from it.  A request
  that decoded through a reused (hit) cache is compared by its own
  tokens, so a cache that decoding changed shows as a gap.

The sample: the window's requests grouped by (document, served tokens),
as many groups as ``check.max_forwards`` allows, drawn from the seed;
one reference forward a group.  The control (``control=True``) puts the
reference in fp8 in the program's place: its own prefill logits, and at
each position the token it puts first.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from bench.reference import blocks, router


def route_mismatches(records: Sequence, traffic: Dict) -> int:
    ref = router.replay(traffic["cluster"],
                        traffic["stream"]["router_seed"],
                        [r.label for r in records])
    return sum((tuple(r.probes), r.hit) != want
               for r, want in zip(records, ref))


def sample(window: Sequence, seed: int, max_forwards: int
           ) -> List[Tuple[int, Tuple[int, ...], int]]:
    """(document label, served tokens, requests) of the sampled groups:
    groups whose document was prefilled in the window and groups that
    only hit, taken in turns, each in an order drawn from the seed."""
    groups: Dict[Tuple[int, Tuple[int, ...]], int] = {}
    filled = {r.label for r in window if not r.hit}
    for r in window:
        key = (r.label, r.tokens)
        groups[key] = groups.get(key, 0) + 1
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    pools = [[k for k in groups if (k[0] in filled) == f] for f in (1, 0)]
    pools = [[p[i] for i in rng.permutation(len(p))] for p in pools]
    turns = [k for pair in zip(*pools) for k in pair]
    n = min(len(p) for p in pools)
    turns += pools[0][n:] + pools[1][n:]
    return [(k[0], k[1], groups[k]) for k in turns[:max_forwards]]


def _served(row: torch.Tensor, tok: int, vocab: int) -> float:
    """The logit of served token ``tok``: the program takes the argmax over
    the padded vocabulary and clips it to ``vocab - 1``, so the last id
    stands for itself and every padded id."""
    return float(row[vocab - 1:].max() if tok == vocab - 1 else row[tok])


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b).norm() / b.norm())


def compare(ref_model, params, model: Dict, docs, groups, prefills: Dict,
            vocab: int, device, control: bool = False) -> Dict:
    """The numbers of the program (or, with ``control``, of the fp8
    reference in its place) against the float32 reference."""
    blocks.float32_matmuls()
    exact, low = blocks.Matmul(False), blocks.Matmul(True)
    errs, gaps, tokens = [], [], 0
    with torch.no_grad():
        for label, served, count in groups:
            doc = torch.as_tensor(docs(label)[0], dtype=torch.int64,
                                  device=device)
            s, n = doc.shape[0], len(served)
            seq = torch.cat([doc, torch.as_tensor([0, *served[:-1]],
                                                  dtype=torch.int64,
                                                  device=device)])
            at = list(range(s - 1, s + n))
            ref = ref_model.logits(params, model, seq, at, exact)
            if control:
                low_l = ref_model.logits(params, model, seq, at, low)
                errs.append(_rel(low_l[0], ref[0]))
                first = low_l[1:].argmax(-1).clamp(max=vocab - 1).tolist()
                picks = first
            else:
                errs += [_rel(lg[0], ref[0])
                         for lg in prefills.get(label, [])]
                picks = served
            for k, tok in enumerate(picks):
                row = ref[k + 1]
                gaps.append(float(row.max()) - _served(row, tok, vocab))
            tokens += n * count
            del ref
    # nothing compared reads None, which no limit passes
    return {"prefill_logit_err": max(errs) if errs else None,
            "decode_gap": max(gaps) if gaps else None,
            "prefills_compared": len(errs), "tokens_compared": tokens,
            "forwards": len(groups)}
