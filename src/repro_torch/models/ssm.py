"""Mamba2 (state-space duality) blocks in PyTorch — the port of the JAX
package's ``repro.models.ssm``: chunked SSD forward and decode step.

``ssd_reference`` (the O(S) sequential oracle) and ``ssd_chunked`` (all
chunk states at once, then the carry) are plain torch, as in the JAX
package.  ``mamba_forward`` computes the SSD in one of two ways: with
``kernel=True`` (the default, the Mamba2 prefill) through the SSD kernel
(``kernels.ssd.ssd_scan``: the CUDA kernel on the card, its plain version
on the CPU), with ``kernel=False`` (``forward`` and the loss) through the
differentiable ``ssd_chunked``, as the JAX code does
(``src/repro/models/ssm.py:168``).  The kernel has no backward and
refuses inputs that require a gradient.

B/C groups (``cfg.ssm_groups``, Mamba2's ``ngroups``): the conv runs over
x and every group's B and C (``conv_dim = d_inner + 2 g N``), head h reads
group h // (H / g), and the gated norm is taken per group of ``d_inner /
g`` channels (``Zamba2RMSNormGated``).  One group takes the JAX package's
path, B/C [b, s, n]; more give B/C [b, s, g, n] to the scan and the
decode step.  Groups are computed on one device only (the model axis
refuses them).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tp
from repro_torch.kernels.ssd import ssd_scan
from repro_torch.kernels.ssd.ref import by_group
from repro_torch.models.layers import dense_init, gated_rms_norm, zeros

F32 = torch.float32
Params = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------


def ssd_reference(x, dt, A, B, C, *, initial_state=None):
    """Sequential scan oracle.  x: [b,s,h,p]; dt: [b,s,h]; A: [h];
    B/C: [b,s,n] or [b,s,g,n].  Returns (y [b,s,h,p], final_state
    [b,h,p,n])."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    state = (torch.zeros((b, h, p, n), dtype=F32, device=x.device)
             if initial_state is None else initial_state.to(F32))
    ys = []
    for t in range(s):
        state, y = _step(state, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), state


def _per_head(t, h: int):
    """B or C of one step, [b,g,n], as [b,h,n]: head h reads its group."""
    return t.repeat_interleave(h // t.shape[1], dim=1)


def _step(state, x, dt, A, B, C):
    dA = torch.exp(dt * A)                                      # [b,h]
    if B.dim() == 3:                                            # groups
        B, C = _per_head(B, x.shape[1]), _per_head(C, x.shape[1])
        dBx = torch.einsum("bhp,bhn,bh->bhpn", x.to(F32), B.to(F32), dt)
        state = state * dA[..., None, None] + dBx
        return state, torch.einsum("bhpn,bhn->bhp", state, C.to(F32))
    dBx = torch.einsum("bhp,bn,bh->bhpn", x.to(F32), B.to(F32), dt)
    state = state * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", state, C.to(F32))
    return state, y


def ssd_chunked(x, dt, A, B, C, *, chunk: int, initial_state=None):
    """Chunked SSD with the semantics of :func:`ssd_reference`: every
    chunk's summary state at once, then the carry across chunks.  Its
    gradient stays finite where the JAX ``ssd_chunked``'s is NaN (an
    overflowing decay above the diagonal, ROADMAP C-ref-10).  B/C
    [b,s,g,n] (groups) are read per head."""
    if B.dim() == 4:
        return by_group(ssd_chunked, x, dt, A, B, C, chunk=chunk,
                         initial_state=initial_state)
    b, s_orig, h, p = x.shape
    n = B.shape[-1]
    pad = (-s_orig) % chunk
    if pad:  # dt = 0 in the tail: decay 1, no input, state unaffected
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    s = x.shape[1]
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).to(F32)
    dtc = dt.reshape(b, nc, chunk, h).to(F32)
    Bc = B.reshape(b, nc, chunk, n).to(F32)
    Cc = C.reshape(b, nc, chunk, n).to(F32)

    cum = torch.cumsum(dtc * A, dim=2)                          # [b,nc,l,h]
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # [b,nc,i,j,h]
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()[None, None, :, :, None]
    # exp of the masked seg (-inf above the diagonal, so 0 there): the same
    # values as the JAX code's where(mask, exp(seg), 0), whose gradient is
    # NaN once an above-diagonal exp(seg) overflows float32 (0 * inf;
    # ROADMAP C-ref-10: mamba2-370m's 128-token chunks do)
    Lmat = torch.exp(seg.masked_fill(~mask, float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    w = cb[..., None] * Lmat * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w, xc)
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bclh,bclh,bcln,bclhp->bchpn", decay_to_end, dtc,
                          Bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # [b,nc,h]
    stat = (torch.zeros((b, h, p, n), dtype=F32, device=x.device)
            if initial_state is None else initial_state.to(F32))
    prev = []
    for c in range(nc):                                         # entering c
        prev.append(stat)
        stat = stat * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                      # [b,nc,h,p,n]
    y_inter = torch.einsum("bclh,bcln,bchpn->bclhp", torch.exp(cum), Cc,
                           prev_states)
    y = (y_intra + y_inter).reshape(b, s, h, p)[:, :s_orig]
    return y.to(x.dtype), stat


def ssd_step(state, x, dt, A, B, C):
    """Single decode step.  state: [b,h,p,n]; x: [b,h,p]; dt: [b,h];
    B/C: [b,n] or [b,g,n]."""
    state, y = _step(state, x, dt, A, B, C)
    return state, y.to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba2 block (projections + conv + SSD + gated norm)
# ---------------------------------------------------------------------------


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, pdt) -> Params:
    d, di, n, nh, w = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_conv)
    conv_dim, gn = cfg.conv_dim, cfg.ssm_groups * cfg.ssm_state
    lo, hi = math.log(1e-3), math.log(1e-1)
    dev = gen.device
    u = torch.rand(nh, generator=gen, dtype=F32, device=dev) * (hi - lo) + lo
    dt_bias = torch.log(torch.expm1(torch.exp(u)))
    return {
        "in_proj": dense_init(gen, (d, 2 * di + 2 * gn + nh), pdt),
        "conv_w": dense_init(gen, (w, conv_dim), pdt,
                             scale=1.0 / math.sqrt(w)),
        "conv_b": zeros(gen, (conv_dim,), pdt),
        "out_proj": dense_init(gen, (di, d), pdt),
        "A_log": torch.log(torch.rand(nh, generator=gen, dtype=F32,
                                      device=dev) * 15.0 + 1.0),
        "D": torch.ones((nh,), dtype=F32, device=dev),
        "dt_bias": dt_bias,
        "norm_w": zeros(gen, (di,), pdt),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv as a shifted sum.  x: [B,S,C]; w: [W,C].
    (Not ``F.conv1d``: cuDNN would run it in TF32.)"""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros_like(x)
    for i in range(W):
        out = out + xp[:, i: i + x.shape[1], :] * w[i]
    return out + b


def _heads(p: Params):
    """(A_log, D, dt_bias, axis) of the SSM heads this rank computes: its
    block of them where the model axis cuts ``A_log`` (and the rules cut
    ``D`` and ``dt_bias`` alike, all three [H]), with the axis; else every
    head and None."""
    (a, dim, ax), (d, _, _), (dtb, _, _) = (tp.part(p[n]) for n in
                                            ("A_log", "D", "dt_bias"))
    return a, d, dtb, (ax if dim is not None else None)


def _gated_norm(y, z, w, eps: float, y_ax, groups: int = 1):
    """``gated_rms_norm(y, z, w)`` over the whole ``d_inner`` (each of
    ``groups`` blocks of it apart): with ``y_ax`` ``y`` and ``z`` are the
    rank's block of it.  Returns (out, axis of out's block or None): a
    norm weight cut over the model axis gives a block of a whole ``y``."""
    if groups > 1:
        if y_ax is not None or tp.part(w)[1] is not None:
            raise NotImplementedError(
                "Mamba2 B/C groups on the model axis are not implemented")
        shape = y.shape
        yg = y.reshape(*shape[:-1], groups, -1)
        zg = z.reshape(*shape[:-1], groups, -1)
        out = gated_rms_norm(yg, zg, w.reshape(groups, -1), eps)
        return out.reshape(shape), None
    wl, w_dim, w_ax = tp.part(w)
    if y_ax is None and w_dim is not None:
        y, z, y_ax = tp.block(y, -1, w_ax), tp.block(z, -1, w_ax), w_ax
    elif y_ax is not None and w_dim is None:
        wl = tp.block(wl, 0, y_ax)
    return gated_rms_norm(y, z, wl, eps, y_ax), y_ax


def mamba_forward(p: Params, x, cfg: ModelConfig, *, initial_state=None,
                  conv_init=None, return_cache: bool = False,
                  kernel: bool = True, sp=None):
    """Full-sequence Mamba2 block.  x: [B,S,d] -> [B,S,d] (and, with
    ``return_cache``, the final SSD state and the conv history).  The SSD
    runs through the kernel (``ssd_scan``) unless ``kernel`` is False,
    then through the differentiable ``ssd_chunked``.

    On the model axis (``distributed.tp``): the in-projection's columns
    are gathered (a rank's column block mixes z, x, B, C and dt, whose
    order checkpoints fix); the depthwise conv runs on the rank's block
    of ``conv_dim`` channels where ``conv_w`` is cut (its conv history
    that block, the reference cache's ``(.., "model")``), and its output
    is gathered; the scan runs on the rank's heads where ``A_log`` is cut
    (the state those heads), the gated norm over the whole ``d_inner``
    (its sum of squares all-reduced), and ``out_proj`` is row-parallel;
    with ``sp`` (``x`` the whole sequence of a sequence-parallel
    residual, gathered by ``tp.gather_seq``) the output is the rank's
    block of the sequence.  Every collective carries its gradient
    (``distributed.tp``), so ``kernel=False`` trains on the shards."""
    b, s, d = x.shape
    di, n, nh, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    g, gn = cfg.ssm_groups, cfg.ssm_groups * cfg.ssm_state
    cdt = x.dtype
    zxbcdt = tp.col_full(x, p["in_proj"], sp)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * gn, nh], dim=-1)
    cw, c_dim, c_ax = tp.part(p["conv_w"])
    c_ax = c_ax if c_dim is not None else None
    xbc = tp.block(xbc, -1, c_ax)
    conv_w, conv_b = cw.to(cdt), tp.part(p["conv_b"])[0].to(cdt)
    if conv_init is not None:
        xbc_in = torch.cat([conv_init.to(cdt), xbc], dim=1)
        xbc_conv = _causal_conv(xbc_in, conv_w, conv_b)[:, conv_init.shape[1]:]
    else:
        xbc_conv = _causal_conv(xbc, conv_w, conv_b)
    xbc_conv = tp.gather(F.silu(xbc_conv), -1, c_ax)
    xs, B, C = torch.split(xbc_conv, [di, gn, gn], dim=-1)
    if g > 1:
        B, C = B.reshape(b, s, g, n), C.reshape(b, s, g, n)
    A_log, D, dt_bias, h_ax = _heads(p)
    # B and C are whole and every rank's heads read them: their gradient
    # is the ranks' parts summed
    B, C = tp.sum_grad(B, h_ax), tp.sum_grad(C, h_ax)
    dt = F.softplus(tp.block(dt_raw, -1, h_ax).to(F32) + dt_bias)  # [B,S,H]
    A = -torch.exp(A_log)                                       # [H]
    xh = tp.block(xs.reshape(b, s, nh, ph), 2, h_ax)
    if kernel:
        y, final_state = ssd_scan(xh.contiguous(), dt.contiguous(), A,
                                  B.contiguous(), C.contiguous(),
                                  chunk=min(cfg.ssm_chunk, s),
                                  initial_state=initial_state)
    else:
        y, final_state = ssd_chunked(xh, dt, A, B, C,
                                     chunk=min(cfg.ssm_chunk, s),
                                     initial_state=initial_state)
    y = y + xh * D.to(cdt)[:, None]
    y = y.reshape(b, s, xh.shape[2] * ph)
    y, y_ax = _gated_norm(y, tp.block(z, -1, h_ax), p["norm_w"],
                          cfg.norm_eps, h_ax, g)
    out = tp.row(y, p["out_proj"], y_ax, sp)
    if return_cache:
        w1 = cfg.ssm_conv - 1
        hist = xbc if conv_init is None else \
            torch.cat([conv_init.to(cdt), xbc], dim=1)
        if hist.shape[1] >= w1:
            # a copy: a view would keep the whole [B, S, ...] projection
            # alive for as long as the cache lives
            conv_cache = hist[:, hist.shape[1] - w1:, :].clone()
        else:
            conv_cache = F.pad(hist, (0, 0, w1 - hist.shape[1], 0))
        return out, final_state, conv_cache
    return out


def mamba_step(p: Params, x, cfg: ModelConfig, state, conv_cache):
    """One-token Mamba2 step.  x: [B,1,d]; state: [B,H,P,N] float32;
    conv_cache: [B,W-1,conv_dim].  Returns (out [B,1,d], new_state,
    new_conv_cache).  On the model axis as :func:`mamba_forward`: the
    state holds the rank's heads and the conv history its channels where
    the parameters are cut so (the reference's ``cache_shardings``)."""
    b = x.shape[0]
    di, n, nh, ph = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_headdim
    g, gn = cfg.ssm_groups, cfg.ssm_groups * cfg.ssm_state
    cdt = x.dtype
    zxbcdt = tp.col_full(x[:, 0], p["in_proj"])
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * gn, nh], dim=-1)
    cw, c_dim, c_ax = tp.part(p["conv_w"])
    c_ax = c_ax if c_dim is not None else None
    xbc = tp.block(xbc, -1, c_ax)
    _expect(conv_cache, -1, xbc.shape[-1], "conv")
    window = torch.cat([conv_cache.to(cdt), xbc[:, None]], dim=1)  # [B,W,cd]
    conv_out = torch.einsum("bwc,wc->bc", window, cw.to(cdt)) + \
        tp.part(p["conv_b"])[0].to(cdt)
    conv_out = tp.gather(F.silu(conv_out), -1, c_ax)
    xs, B, C = torch.split(conv_out, [di, gn, gn], dim=-1)
    if g > 1:
        B, C = B.reshape(b, g, n), C.reshape(b, g, n)
    A_log, D, dt_bias, h_ax = _heads(p)
    dt = F.softplus(tp.block(dt_raw, -1, h_ax).to(F32) + dt_bias)  # [B,H]
    A = -torch.exp(A_log)
    xh = tp.block(xs.reshape(b, nh, ph), 1, h_ax)
    _expect(state, 1, xh.shape[1], "state")
    state, y = ssd_step(state, xh, dt, A, B, C)
    y = y + xh * D.to(cdt)[:, None]
    y, y_ax = _gated_norm(y.reshape(b, -1), tp.block(z, -1, h_ax),
                          p["norm_w"], cfg.norm_eps, h_ax, g)
    out = tp.row(y, p["out_proj"], y_ax)[:, None]
    return out, state, window[:, 1:]


def _expect(cache, dim: int, size: int, name: str) -> None:
    if cache.shape[dim] != size:
        raise ValueError(
            f"the decode cache's {name} holds {cache.shape[dim]} along dim "
            f"{dim}, the parameters' layout gives this rank {size}: lay the "
            f"cache out by launch.specs.cache_shardings for parameters "
            f"laid out by distributed.sharding.param_shardings")
