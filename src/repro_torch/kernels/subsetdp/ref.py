"""Plain PyTorch version of the subset-DP kernel (any device, float64).

Computes the Eq. (10) value of EVERY subset mask m for a batch of rho
rows: ``phi[b, m] = cost[m] + M_b * prod_{j in m} rhos[b, j]``.

The scalar reference loop accumulates a subset's cost and exclusion
product by ASCENDING cache index; n masked multiply sweeps in ascending j
reproduce that IEEE operation order exactly, because multiplying a lane by
exactly 1.0 (or adding exactly 0.0 to a non-negative partial sum) is an
identity.  Every op here is a separate eager torch op, so nothing can
contract the final ``cost + prod`` into an FMA — the CUDA kernel
(``csrc/subsetdp.cu``) gets the same guarantee from the ``_rn`` intrinsics
and ``--fmad=false``.  The argmin takes the FIRST minimum in ascending-
mask order (``torch.argmin``'s documented tie rule), like ``np.argmin``
and the scalar enumeration.
"""
from __future__ import annotations

import torch

F64 = torch.float64

#: float64 elements (rows * 2^n) per argmin chunk: bounds the [rows, 2^n]
#: working set of the plain version near 32 MB (the kernel has none)
CHUNK_ELEMS = 1 << 22


def _lanes(n: int, device) -> torch.Tensor:
    return torch.arange(1 << n, dtype=torch.int64, device=device)


def subset_costs_ref(costs: torch.Tensor, n: int) -> torch.Tensor:
    """[2^n] per-subset cost sums, ascending-index add order (bitwise equal
    to the scalar enumeration's running cost)."""
    lanes = _lanes(n, costs.device)
    cost = torch.zeros(1 << n, dtype=F64, device=costs.device)
    zero = torch.zeros((), dtype=F64, device=costs.device)
    for j in range(n):
        bit = ((lanes >> j) & 1).bool()
        cost = cost + torch.where(bit, costs[j], zero)
    return cost


def subset_prod_ref(rhos: torch.Tensor, mp: torch.Tensor) -> torch.Tensor:
    """[B, 2^n] subset exclusion products times M (``mp``: [1] shared or
    [B] per row), ascending-index multiply order — the kernel's
    ``subsetdp_prod``."""
    b, n = rhos.shape
    lanes = _lanes(n, rhos.device)
    one = torch.ones((), dtype=F64, device=rhos.device)
    prod = mp.reshape(-1, 1).expand(b, 1 << n).clone()
    for j in range(n):              # ascending-index order
        bit = ((lanes >> j) & 1).bool()
        prod = prod * torch.where(bit[None, :], rhos[:, j:j + 1], one)
    return prod


def subset_argmin_ref(cost: torch.Tensor, rhos: torch.Tensor,
                      mp: torch.Tensor, allowed=None) -> torch.Tensor:
    """[B] int64 first-minimum subset per row of ``cost + prod`` over the
    masks inside ``allowed`` ([B] int64, or None for all) — the kernel's
    ``subsetdp_argmin``, chunked over rows so the plain version's
    [rows, 2^n] matrix stays bounded."""
    b, n = rhos.shape
    k = 1 << n
    lanes = _lanes(n, rhos.device)
    out = torch.empty(b, dtype=torch.int64, device=rhos.device)
    step = max(1, CHUNK_ELEMS // k)
    per_row = mp.numel() > 1
    for lo in range(0, b, step):
        hi = min(lo + step, b)
        phi = cost[None, :] + subset_prod_ref(
            rhos[lo:hi], mp[lo:hi] if per_row else mp)
        if allowed is not None:
            bad = (lanes[None, :] & ~allowed[lo:hi, None]) != 0
            phi = phi.masked_fill(bad, float("inf"))
        out[lo:hi] = torch.argmin(phi, dim=1)
    return out
