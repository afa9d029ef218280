"""Plain PyTorch version of the flash-attention kernel (GQA, causal or not).

It computes what ``csrc/flash.cu`` computes, with the TPU kernel's
arithmetic conventions (``src/repro/kernels/flash_attention/flash.py``):
q is cast to float32 and then scaled by D^-1/2 (or the caller's
``scale``); scores are float32; a
masked score is -1e30; the PV product takes p in float32 (the TPU kernel
casts v to float32 at ``flash.py:52``, so its ``p.astype(v.dtype)`` at
``:64`` keeps p in float32) and the denominator sums the same p; the
final divide clamps the denominator at 1e-30.  Only o is rounded to q's
type.  The kernels fold the key axis in tiles with an online softmax;
this version takes each row's softmax over all keys at once, so the two
differ only by float32 rounding.

Causal masking compares positions that both start at 0 (query i sees
keys j <= i), as the TPU kernel and ``attention_naive`` do: prefill only.
``q_offset`` shifts the query positions (query i sees keys j <= i +
q_offset), so that a block of a long prefill's queries can be checked
against the keys before it without the whole score matrix.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
F32 = torch.float32


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        q_offset: int = 0, scale=None) -> torch.Tensor:
    """q: [B,Sq,Hq,D]; k/v: [B,Sk,Hkv,D] (model layout) -> [B,Sq,Hq,D] in
    q's type."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf = q.to(F32).reshape(b, sq, hkv, g, d) * (
        d ** -0.5 if scale is None else scale)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.to(F32))     # [B,Hkv,G,Sq,Sk]
    if causal:
        mask = (torch.arange(sq, device=q.device)[:, None] + q_offset
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgqk,bkhd->bhgqd", p, v.to(F32))
    o = acc / torch.clamp(l, min=1e-30)                       # [B,Hkv,G,Sq,D]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)
