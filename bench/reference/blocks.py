"""Plain PyTorch building blocks of the benchmark's model references.

Everything here is written from the published equations, in float32, with
no kernel, no cache and no batching: a whole sequence goes through every
layer at once.  It imports nothing of the program under test.  Matrix
products go through a :class:`Matmul`, which computes them in float32
(TF32 off) or, for the precision control, with both operands rounded to
fp8 e4m3 first (one scale per row of the activations and per output
column of the weights), the step below the bf16 that the configurations
state.

Conventions the program's parameters follow (and the published models):
RMS norms scale by ``1 + w``; the Mamba2 block is in-projection -> depthwise causal conv over (x, B, C) ->
SiLU -> selective scan with a scalar decay per head -> gated RMS norm ->
out-projection (arXiv:2405.21060, one B/C group).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0


def float32_matmuls() -> None:
    """Full float32 products: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 with one absmax scale along ``dim``."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(F32) * scale


class Matmul:
    """``x @ w`` in float32, or (``fp8=True``) of fp8-rounded operands."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        x, w = x.to(F32), w.to(F32)
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, 0)
        return x @ w


def rms_norm(x, w, eps: float):
    x = x.to(F32)
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        (1.0 + w.to(F32))


def selective_scan(x, dt, A, B, C, chunk: int = 128):
    """The Mamba2 recurrence h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t, computed exactly by blocks of ``chunk`` steps.
    x [S, H, P], dt [S, H], A [H], B/C [S, N] -> y [S, H, P]."""
    s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:     # dt = 0: decay 1 and no input, the state passes unchanged
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad))
    nc = x.shape[0] // chunk
    x = x.reshape(nc, chunk, h, p)
    dt = dt.reshape(nc, chunk, h)
    B, C = B.reshape(nc, chunk, n), C.reshape(nc, chunk, n)
    cum = torch.cumsum(dt * A, dim=1)                          # [c, l, h]
    seg = cum[:, :, None, :] - cum[:, None, :, :]              # [c, i, j, h]
    keep = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()[None, :, :, None]
    decay = torch.exp(seg.masked_fill(~keep, float("-inf")))
    cb = torch.einsum("cin,cjn->cij", C, B)
    y = torch.einsum("cijh,cjhp->cihp",
                     cb[..., None] * decay * dt[:, None, :, :], x)
    to_end = torch.exp(cum[:, -1:, :] - cum) * dt              # [c, l, h]
    local = torch.einsum("clh,cln,clhp->chpn", to_end, B, x)   # [c, h, p, n]
    whole = torch.exp(cum[:, -1, :])                           # [c, h]
    state = torch.zeros((h, p, n), dtype=F32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * whole[c][:, None, None] + local[c]
    y = y + torch.einsum("clh,cln,chpn->clhp", torch.exp(cum), C,
                         torch.stack(entering))
    return y.reshape(nc * chunk, h, p)[:s]


def mamba2_block(p, x, m: Matmul, *, d_inner: int, n: int, headdim: int,
                 conv: int, eps: float):
    """One Mamba2 mixer on the normed residual x [S, d] -> [S, d]."""
    s = x.shape[0]
    h = d_inner // headdim
    zxbcdt = m(x, p["in_proj"])
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * n, h], dim=-1)
    w = p["conv_w"].to(F32)                                    # [W, ch]
    xp = F.pad(xbc, (0, 0, conv - 1, 0))
    xbc = sum(xp[i: i + s] * w[i] for i in range(conv)) + p["conv_b"].to(F32)
    xs, B, C = torch.split(F.silu(xbc), [d_inner, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].to(F32))
    A = -torch.exp(p["A_log"].to(F32))
    xs = xs.reshape(s, h, headdim)
    y = selective_scan(xs, dt, A, B, C) + xs * p["D"].to(F32)[:, None]
    y = y.reshape(s, d_inner) * F.silu(z)
    y = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + eps) * \
        (1.0 + p["norm_w"].to(F32))
    return m(y, p["out_proj"])
