"""Public wrappers for the subset-DP kernel.

``subset_prod`` returns the [B, 2^n] exclusion products (the exact
counterpart of the JAX package's Pallas kernel), ``subset_dp`` the full
Eq. (10) value matrix, and ``subset_argmin`` the winning subset mask per
row — fused in the kernel, so the [B, 2^n] matrix never reaches device
memory.  The exhaustive table builders (``repro_torch.core.batched``) use
``subset_argmin``.

Dispatch is by the device of the tensors: a CUDA tensor launches the
hand-written kernel (``csrc/subsetdp.cu``, built at first use by
``build.py``) or raises; a CPU tensor takes the plain version
(``ref.py``).  NumPy or scalar inputs are placed on ``device`` first,
which defaults to ``cuda`` (and raises without a GPU).  Everything is
float64 and BIT-EXACT with the scalar enumeration: the final
``cost + prod`` add is never contracted into an FMA on either path.

``LAUNCHES`` counts kernel launches per entry point (the plain path
counts nothing), so a run can show it went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.device import F64, I64, DeviceLike, tensor_device
from repro_torch.kernels.subsetdp import ref

#: kernel launches per entry point since the last ``reset_launches()``
LAUNCHES = {"subset_prod": 0, "subset_argmin": 0}
#: largest n the kernel takes (2^n lanes per row; rho row in shared memory)
MAX_N = 16


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _inputs(rhos, miss_penalty, device: DeviceLike):
    """(rhos [B, n] f64, mp [1] or [B] f64) contiguous on one device."""
    dev = tensor_device(rhos, device)
    rhos = torch.as_tensor(rhos, dtype=F64, device=dev).contiguous()
    if rhos.dim() != 2:
        raise ValueError(f"rhos must be [B, n], got {tuple(rhos.shape)}")
    n = rhos.shape[1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"subset-DP takes 1 <= n <= {MAX_N}, got n={n}")
    mp = torch.as_tensor(miss_penalty, dtype=F64, device=dev).reshape(-1)
    if mp.numel() not in (1, rhos.shape[0]):
        raise ValueError(
            f"miss_penalty must be a scalar or [B={rhos.shape[0]}], got "
            f"{mp.numel()} values")
    return rhos, mp.contiguous()


# Launches go on torch's current stream and return without synchronising.
# Temporaries handed to a launch (the cost vector, converted inputs) may
# be released when the wrapper returns: torch's caching allocator reuses a
# block only for work ordered after it on the same stream, so the kernel
# has finished with it by then.


def _check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"subset-DP kernel {name} launch failed: CUDA "
                           f"error {code}")


def subset_costs(costs, n: int, device) -> torch.Tensor:
    """[2^n] per-subset cost sums (ascending-index adds) on ``device``."""
    costs = torch.as_tensor(costs, dtype=F64, device=device)
    return ref.subset_costs_ref(costs, n)


def subset_prod(rhos, miss_penalty, *, device: DeviceLike = None
                ) -> torch.Tensor:
    """[B, 2^n] float64 subset exclusion products ``M * prod_{j in m} rho_j``
    (``miss_penalty``: scalar or [B] per row)."""
    rhos, mp = _inputs(rhos, miss_penalty, device)
    b, n = rhos.shape
    if rhos.device.type == "cpu":
        return ref.subset_prod_ref(rhos, mp)
    if rhos.device.type != "cuda":
        raise ValueError(f"unsupported device {rhos.device}")
    out = torch.empty((b, 1 << n), dtype=F64, device=rhos.device)
    if b == 0:
        return out
    from repro_torch.kernels.subsetdp.build import load
    lib = load()
    with torch.cuda.device(rhos.device):
        stream = torch.cuda.current_stream(rhos.device).cuda_stream
        _check(lib.subsetdp_prod(rhos.data_ptr(), mp.data_ptr(),
                                 int(mp.numel() > 1), out.data_ptr(), b, n,
                                 stream), "subsetdp_prod")
    LAUNCHES["subset_prod"] += 1
    return out


def subset_dp(costs, rhos, miss_penalty, *, device: DeviceLike = None
              ) -> torch.Tensor:
    """[B, 2^n] float64 Eq. (10) subset values ``cost[m] + prod[b, m]`` —
    the final add is its own eager op, so it rounds exactly like the
    oracle's two-rounding ``cost_m + prod_m``."""
    prod = subset_prod(rhos, miss_penalty, device=device)
    return subset_costs(costs, prod.shape[1].bit_length() - 1,
                        prod.device)[None, :] + prod


def subset_argmin(costs, rhos, miss_penalty, *, allowed=None,
                  device: DeviceLike = None) -> torch.Tensor:
    """[B] int64 winning subset masks: the Eq. (10) minimiser per row,
    FIRST minimum in ascending-mask order.  ``allowed`` ([B] int64,
    optional) restricts row b to subsets of ``allowed[b]`` (the CS_FNO
    candidate set; the empty set is always allowed); ``miss_penalty`` is a
    scalar or [B] per row."""
    rhos, mp = _inputs(rhos, miss_penalty, device)
    b, n = rhos.shape
    cost = subset_costs(costs, n, rhos.device)
    if allowed is not None:
        allowed = torch.as_tensor(allowed, dtype=I64,
                                  device=rhos.device).contiguous()
        if allowed.shape != (b,):
            raise ValueError(f"allowed must be [B={b}], got "
                             f"{tuple(allowed.shape)}")
    if rhos.device.type == "cpu":
        return ref.subset_argmin_ref(cost, rhos, mp, allowed)
    if rhos.device.type != "cuda":
        raise ValueError(f"unsupported device {rhos.device}")
    out = torch.empty(b, dtype=I64, device=rhos.device)
    if b == 0:
        return out
    from repro_torch.kernels.subsetdp.build import load
    lib = load()
    with torch.cuda.device(rhos.device):
        stream = torch.cuda.current_stream(rhos.device).cuda_stream
        _check(lib.subsetdp_argmin(
            cost.data_ptr(), rhos.data_ptr(), mp.data_ptr(),
            int(mp.numel() > 1),
            None if allowed is None else allowed.data_ptr(),
            out.data_ptr(), b, n, stream), "subsetdp_argmin")
    LAUNCHES["subset_argmin"] += 1
    return out
