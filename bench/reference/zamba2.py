"""Plain PyTorch blocks of the published Zamba2 layer (Zyphra's
Zamba2-7B-Instruct, arXiv:2411.15242; transformers' ``modeling_zamba2``):
the Mamba2 mixer with B/C groups and a gated norm per group, and the
shared transformer block applied to [x, embeddings] with an application's
own MLP adapter.  Written from the published equations in float32, a
whole sequence at once, importing nothing of the program; matrix products
with the model's weights go through a :class:`blocks.Matmul` (float32, or
the fp8 control), the scan through :func:`blocks.selective_scan` once a
group, attention in float32.

Conventions of the program's parameters: RMS norms scale by ``1 + w``
(the published weight is 1 + w); matrices are [in, out]; the
in-projection's columns are z, x, every group's B, every group's C, dt;
``adapter_b``'s columns are the gate's, then the up projection's.  dt is
not clamped at ``time_step_min``: the published CUDA path (transformers'
``cuda_kernels_forward``, ``time_step_limit`` (0, inf)) does not clamp it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import blocks as R

F32 = torch.float32


def mamba2_grouped(p, x, m: R.Matmul, *, d_inner: int, n: int, headdim: int,
                   conv: int, groups: int, eps: float):
    """One Mamba2 mixer with ``groups`` B/C groups on the normed input x
    [S, d] -> [S, d]: head h reads group h // (H / groups)."""
    s = x.shape[0]
    h = d_inner // headdim
    gn = groups * n
    zxbcdt = m(x, p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * gn, h], dim=-1)
    w = p["conv_w"].to(F32)                                    # [W, ch]
    xp = F.pad(xbc, (0, 0, conv - 1, 0))
    xbc = sum(xp[i: i + s] * w[i] for i in range(conv)) + p["conv_b"].to(F32)
    xs, B, C = torch.split(F.silu(xbc), [d_inner, gn, gn], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))
    xs = xs.reshape(s, h, headdim)
    hg = h // groups
    y = torch.cat([R.selective_scan(xs[:, k * hg:(k + 1) * hg],
                                    dt[:, k * hg:(k + 1) * hg],
                                    A[k * hg:(k + 1) * hg],
                                    B[:, k * n:(k + 1) * n],
                                    C[:, k * n:(k + 1) * n])
                   for k in range(groups)], dim=1)
    y = y + xs * p["D"].to(F32)[:, None]
    y = (y.reshape(s, d_inner) * F.silu(z)).reshape(s, groups, -1)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + eps)
    y = y.reshape(s, d_inner) * (1.0 + p["norm_w"].to(F32))
    return m(y, p["out_proj"])


def rope(x, theta: float):
    """Rotary embedding over the whole head dim of x [S, H, D], the two
    halves rotated together (``rotate_half``), positions 0..S-1."""
    s, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=F32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=F32, device=x.device)[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
    half = torch.cat([-x[..., d // 2:], x[..., : d // 2]], -1)
    return x * cos + half * sin


def shared_block(sp, ap, x, e, m: R.Matmul, *, heads: int, kv_heads: int,
                 head_dim: int, scale: float, theta: float, d_ff: int,
                 eps: float):
    """One application of a shared transformer block to the residual x
    [S, d] with the embeddings e: its output through the application's
    ``linear``, [S, d] (what is added to the Mamba block's input)."""
    s = x.shape[0]
    h = R.rms_norm(torch.cat([x, e], dim=-1), sp["ln1"], eps)
    a = sp["attn"]
    q = rope(m(h, a["wq"]).reshape(s, heads, head_dim), theta)
    k = rope(m(h, a["wk"]).reshape(s, kv_heads, head_dim), theta)
    v = m(h, a["wv"]).reshape(s, kv_heads, head_dim)
    rep = heads // kv_heads
    k, v = k.repeat_interleave(rep, dim=1), v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * scale
    keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
    o = torch.einsum("hqk,khd->qhd", probs, v).reshape(s, heads * head_dim)
    del scores, probs
    h = R.rms_norm(m(o, a["wo"]), sp["ln2"], eps)
    mlp = sp["mlp"]
    gu = m(m(h, ap["adapter_a"]), ap["adapter_b"])
    g = m(h, mlp["wg"]) + gu[:, :d_ff]
    u = m(h, mlp["wi"]) + gu[:, d_ff:]
    t = m(F.gelu(g) * u, mlp["wo"])
    return m(t, ap["linear"])
