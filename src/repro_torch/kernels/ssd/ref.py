"""Plain PyTorch version of the Mamba2 SSD chunked-scan kernel.

It computes what ``csrc/ssd.cu`` computes, as the TPU kernel orders it:
the chunks one after another, an f32 state [b, h, p, n] carried across
them, and per chunk (``src/repro/kernels/ssd/ssd.py:44-62``)

  cum      = inclusive cumsum of dt * A over the chunk
  y[i]     = sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i . B_j) x_j
           + exp(cum_i) (C_i . state)
  state    = state exp(cum_L) + sum_j exp(cum_L - cum_j) dt_j x_j (x) B_j

B and C are [b, s, n] (one group) or [b, s, g, n] (head h reads group
h // (h/g)), with ``models.ssm.ssd_chunked``'s contract: a sequence that is not a
multiple of ``chunk`` is zero-padded at the tail (dt = 0 there leaves the
state unchanged) and y is cut back; ``initial_state`` defaults to zeros.
``exp(cum_i - cum_j)`` is taken only for j <= i (the upper triangle gets
exp(-inf) = 0), so its overflow never meets a 0/1 mask.  The CUDA
kernels compute the same terms chunk-parallel (every chunk's C.B^T and
summary state at once, then the carry), so the two differ only in the
order of float32 sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def ssd_scan_ref(x, dt, A, B, C, *, chunk: int, initial_state=None):
    """x: [b,s,h,p]; dt: [b,s,h]; A: [h]; B/C: [b,s,n] or [b,s,g,n].
    Returns (y [b,s,h,p] in x's type, final_state [b,h,p,n] float32)."""
    if B.dim() == 4:
        return by_group(ssd_scan_ref, x, dt, A, B, C, chunk=chunk,
                         initial_state=initial_state)
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    xf = F.pad(x.to(F32), (0, 0, 0, 0, 0, pad))
    dtf = F.pad(dt.to(F32), (0, 0, 0, pad))
    Bf = F.pad(B.to(F32), (0, 0, 0, pad))
    Cf = F.pad(C.to(F32), (0, 0, 0, pad))
    A = A.to(F32)
    state = (torch.zeros((b, h, p, n), dtype=F32, device=x.device)
             if initial_state is None else initial_state.to(F32))
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=x.device).tril()[None, :, :, None]
    ys = []
    for c0 in range(0, s + pad, chunk):
        xc, dtc = xf[:, c0:c0 + chunk], dtf[:, c0:c0 + chunk]
        Bc, Cc = Bf[:, c0:c0 + chunk], Cf[:, c0:c0 + chunk]
        cum = torch.cumsum(dtc * A, dim=1)                      # [b,l,h]
        seg = cum[:, :, None, :] - cum[:, None, :, :]           # [b,i,j,h]
        decay = torch.exp(torch.where(lower, seg, -torch.inf))
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)
        w = cb[..., None] * decay * dtc[:, None, :, :]
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bin,bhpn->bihp", Cc, state)
        to_end = torch.exp(cum[:, -1:] - cum) * dtc             # [b,l,h]
        state = state * torch.exp(cum[:, -1])[..., None, None] + \
            torch.einsum("blh,blhp,bln->bhpn", to_end, xc, Bc)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :s].to(x.dtype), state


def by_group(scan, x, dt, A, B, C, *, initial_state=None, **kw):
    """``scan`` with B/C [b,s,g,n]: each group's heads with its B and C,
    their y concatenated over the heads and their states likewise."""
    g = B.shape[2]
    hg = x.shape[2] // g
    init = [None] * g if initial_state is None else \
        initial_state.split(hg, dim=1)
    outs = [scan(x[:, :, k * hg:(k + 1) * hg], dt[:, :, k * hg:(k + 1) * hg],
                 A[k * hg:(k + 1) * hg], B[:, :, k], C[:, :, k],
                 initial_state=init[k], **kw) for k in range(g)]
    return (torch.cat([y for y, _ in outs], dim=2),
            torch.cat([st for _, st in outs], dim=1))
