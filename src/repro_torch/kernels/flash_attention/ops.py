"""Public wrapper for the flash-attention kernel.

``flash_attention(q, k, v, causal=True, scale=None)`` takes the model
layout — q [B,Sq,Hq,D], k/v [B,Sk,Hkv,D] — and returns [B,Sq,Hq,D] in q's
type (softmax of the scores times ``scale``, D^-1/2 unless given),
as the JAX package's ``kernels.flash_attention.ops.flash_attention``
does (that wrapper transposes to head-major for the Pallas kernel; the
CUDA kernel reads the model layout directly).

Dispatch is by the device of the tensors: a CUDA tensor launches a
hand-written kernel, chosen by type — bf16 the tensor-core kernel
(``csrc/flash_wgmma.cu``: wgmma, TMA loads and stores), float32 the
CUDA-core kernel (``csrc/flash.cu``), both built at first use by
``build.py`` — or raises on a type, shape or layout neither takes; a
CPU tensor takes the plain version (``ref.py``); a meta tensor (the dry
run) passes the kernel's checks and gets an output of the kernel's shape
and type, computing nothing and launching nothing.  NumPy inputs are
placed on ``device`` first, which defaults to ``cuda`` (and raises
without a GPU).  The TPU wrapper's ``block_q``/``block_k`` and its
``sq % block_q == 0`` rule have no counterpart: any Sq and Sk are
taken.  Causal masking assumes that query and key positions both start
at 0 — prefill, not decode.

``LAUNCHES`` counts kernel launches (the plain and meta paths count
nothing).  Every call, on any device, reports ``flash_work`` to an active
cost trace (``kernels.kernel_call``).

The kernels have no backward, so ``flash_attention`` refuses an input
that requires a gradient (``kernels.refuse_grad``, on every device).
Training attends with the differentiable
``repro_torch.models.layers.attn_forward`` (``attention_chunked``), as
the JAX package's loss does.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, tensor_device
from repro_torch.kernels import kernel_call, launch_counter, refuse_grad
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

#: kernel launches since the last ``reset_launches()``
LAUNCHES = launch_counter("flash_attention")
#: head dims the kernel is instantiated for (112: zamba2-7b's shared
#: attention, d 3584 over 32 heads; 224: zamba2-7b-instruct's, the 7168-wide
#: [x, embeddings] over 32 heads)
HEAD_DIMS = (16, 32, 64, 112, 128, 224)
DTYPES = (torch.float32, torch.bfloat16)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def causal_pairs(sq: int, sk: int) -> int:
    """(query, key) pairs a causal top-left mask keeps: query i sees keys
    0..i, at most ``sk``."""
    if sq <= sk:
        return sq * (sq + 1) // 2
    return sk * (sk + 1) // 2 + (sq - sk) * sk


def flash_work(b, sq, sk, hq, hkv, d, causal: bool, elem: int):
    """(flops, bytes) the attention needs: 2 flops per multiply-add of
    QK^T and of PV over the (query, key) pairs the mask keeps; q, k, v
    read once and o written once (``elem`` bytes a value)."""
    pairs = causal_pairs(sq, sk) if causal else sq * sk
    return 4 * b * hq * d * pairs, elem * (2 * b * sq * hq * d +
                                           2 * b * sk * hkv * d)


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B,Sq,Hq,D] and k, v [B,Sk,Hkv,D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1 or sq < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in batch or head dim, or a sequence is empty")
    if hq % k.shape[2]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[2]}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v lie on {q.device}, {k.device}, {v.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    device: DeviceLike = None) -> torch.Tensor:
    """q: [B,Sq,Hq,D]; k/v: [B,Sk,Hkv,D] -> [B,Sq,Hq,D]; the scores are
    scaled by ``scale`` (D^-1/2 when None)."""
    refuse_grad("flash_attention",
                "repro_torch.models.layers.attn_forward (attention_chunked)",
                (q, k, v))
    dev = tensor_device(q, device)
    q, k, v = (x if isinstance(x, torch.Tensor) else
               torch.as_tensor(np.asarray(x), device=dev) for x in (q, k, v))
    _check(q, k, v)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else float(scale)
    with kernel_call("flash_attention",
                     *flash_work(b, sq, sk, hq, hkv, d, causal,
                                 q.element_size())):
        if q.device.type == "cpu":
            return flash_attention_ref(q, k, v, causal=causal, scale=scale)
        if q.device.type not in ("cuda", "meta"):
            raise ValueError(f"unsupported device {q.device}")
        return _kernel(q, k, v, causal, scale)


def _kernel(q, k, v, causal: bool, scale: float) -> torch.Tensor:
    """The kernel's checks, its output, and on the card its launch."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v must share a type in float32/bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("bf16 q, k, v must start on a 16-byte boundary "
                         "(TMA loads)")
    if max(b, hq, -(-sq // 64)) > 65535 or b * sq * hq * d >= 1 << 62:
        raise ValueError(f"shape {tuple(q.shape)} exceeds the launch grid")
    out = torch.empty_like(q)
    if q.device.type == "meta":
        return out
    from repro_torch.kernels.flash_attention import build
    if bf16:
        fn = build.KERNEL_BF16.load().flash_attention_fwd_bf16
    else:
        fn = build.KERNEL.load().flash_attention_fwd_f32
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                  sq, sk, hq, hkv, d, int(bool(causal)), scale, stream)
    if code != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA "
                           f"error {code}")
    LAUNCHES["flash_attention"] += 1
    return out
