"""Public wrapper for the Mamba2 SSD chunked-scan kernel.

``ssd_scan(x, dt, A, B, C, chunk=..., initial_state=None)`` returns
``(y [b,s,h,p], final_state [b,h,p,n] float32)`` with the contract of
``models.ssm.ssd_chunked``: any sequence length (a ragged tail is read as
zeros and cut from y, where the Pallas wrapper asserts ``s % chunk ==
0``) and an optional entering state (zeros when absent).

Dispatch is by the device of the tensors: a CUDA tensor launches the
hand-written kernels (``csrc/ssd.cu``, built at first use by ``build.py``:
five stages — cumsum, C.B^T, chunk states, carry, output — on the
current stream, scratch allocated here) or raises on a type, shape or
layout they do not take; a CPU tensor takes the plain version
(``ref.py``); a meta tensor (the dry run) passes the kernels' checks and
gets outputs and scratch of the kernels' shapes and types, computing
nothing and launching nothing.  B and C are [b,s,n] (one group) or
[b,s,g,n] (Mamba2's ``ngroups``: head h reads group h // (h/g)).  NumPy
inputs are placed on ``device`` first, which defaults to ``cuda`` (and
raises without a GPU).  The kernels take x, B
and C in one type (float32 or bfloat16), dt, A and the state in float32,
head dims p in {16, 32, 64}, n a multiple of 4 with p * n <= 8192, and
chunk <= 256.

``LAUNCHES`` counts calls that went to the card, one per ``ssd_scan``
(the plain and meta paths count nothing); ``MMA_LAUNCHES`` counts those
of them that ran the states and output stages on the tensor cores (bf16
inputs: the float32 operand of each product split into two bf16 parts;
float32 inputs keep the CUDA-core stages).  Every call, on any device,
reports ``ssd_work`` to an active cost trace (``kernels.kernel_call``).

The kernel has no backward, so ``ssd_scan`` refuses an input that
requires a gradient (``kernels.refuse_grad``, on every device).  Training
computes the SSD with the differentiable
``repro_torch.models.ssm.ssd_chunked``, as the JAX package's loss does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, tensor_device
from repro_torch.kernels import kernel_call, launch_counter, refuse_grad
from repro_torch.kernels.ssd.ref import ssd_scan_ref

#: kernel launches since the last ``reset_launches()``
LAUNCHES = launch_counter("ssd_scan")
#: of those, the calls whose states and output stages ran on the tensor cores
MMA_LAUNCHES = launch_counter("ssd_scan_mma")
HEAD_DIMS = (16, 32, 64)
MAX_CHUNK = 256
MAX_STATE = 8192
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
F32 = torch.float32


def reset_launches() -> None:
    for counter in (LAUNCHES, MMA_LAUNCHES):
        for name in counter:
            counter[name] = 0


def ssd_work(b, s, h, p, n, chunk: int, elem: int, g: int = 1):
    """(C.B^T flops, the other products' flops, bytes) the chunked scan
    needs on these rows: per chunk of l real rows, C.B^T over the
    l(l+1)/2 kept pairs once per sequence and group (a group's heads share
    its B and C), and per head the weighted sum over those pairs (p wide),
    the inter-chunk product and the state update (l*p*n each), 2 flops per
    multiply-add (the bf16 kernel runs all of them on the tensor cores,
    the float32 kernel on the CUDA cores); the exps, the cumsum and the scalings
    are lower-order and not counted.  Bytes: x, B, C (``elem`` bytes a
    value), dt, A read once, y and the final state written once."""
    full, tail = divmod(s, chunk)
    pairs = full * (chunk * (chunk + 1) // 2) + tail * (tail + 1) // 2
    cb = b * g * 2 * n * pairs
    rest = b * h * (2 * p * pairs + 4 * s * p * n)
    nbytes = elem * (2 * b * s * h * p + 2 * b * s * g * n) + 4 * (
        b * s * h + h + b * h * p * n)
    return cb, rest, nbytes


def groups_of(B) -> int:
    """B/C groups of ``B`` [b,s,n] (one) or [b,s,g,n]."""
    return B.shape[2] if B.dim() == 4 else 1


def _check(x, dt, A, B, C, chunk, initial_state) -> None:
    if x.dim() != 4:
        raise ValueError(f"x must be [b,s,h,p], got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = B.shape[-1] if B.dim() in (3, 4) else -1
    g = groups_of(B)
    bc = (b, s, n) if B.dim() == 3 else (b, s, g, n)
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) or \
            tuple(B.shape) != bc or C.shape != B.shape or g < 1 or h % g:
        raise ValueError(f"expected dt [b,s,h], A [h], B/C [b,s,n] or "
                         f"[b,s,g,n] with g dividing h for x "
                         f"{tuple(x.shape)}; got {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    if initial_state is not None and \
            tuple(initial_state.shape) != (b, h, p, n):
        raise ValueError(f"initial_state must be {(b, h, p, n)}, got "
                         f"{tuple(initial_state.shape)}")
    if int(chunk) < 1 or s < 1:
        raise ValueError(f"chunk and s must be >= 1, got {chunk}, {s}")
    tensors = [x, dt, A, B, C] + \
        ([] if initial_state is None else [initial_state])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("x, dt, A, B, C and initial_state lie on "
                         "different devices")


def _kernel_checks(x, dt, A, B, C, chunk, initial_state) -> None:
    b, s, h, p = x.shape
    n = B.shape[-1]
    if x.dtype not in DTYPES or not (x.dtype == B.dtype == C.dtype):
        raise ValueError(f"x, B, C must share a type in float32/bfloat16, "
                         f"got {x.dtype}, {B.dtype}, {C.dtype}")
    floats = [dt, A] + ([] if initial_state is None else [initial_state])
    if any(t.dtype != F32 for t in floats):
        raise ValueError("dt, A and initial_state must be float32")
    if p not in HEAD_DIMS or n % 4 or p * n > MAX_STATE:
        raise ValueError(f"head dim p={p} must be in {HEAD_DIMS} and n={n} "
                         f"a multiple of 4 with p*n <= {MAX_STATE}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}")
    if not all(t.is_contiguous() for t in [x, B, C] + floats):
        raise ValueError("x, dt, A, B, C and initial_state must be "
                         "contiguous")
    if h > 65535 or b * h > 65535 or b * s * h * p >= 1 << 62:
        raise ValueError(f"shape {tuple(x.shape)} exceeds the launch grid")
    if initial_state is not None and initial_state.data_ptr() % 16:
        raise ValueError("initial_state must start on a 16-byte boundary")


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128, initial_state=None,
             device: DeviceLike = None):
    """x: [b,s,h,p]; dt: [b,s,h]; A: [h]; B/C: [b,s,n] (single group) or
    [b,s,g,n].  Returns (y [b,s,h,p] in x's type, final_state [b,h,p,n]
    float32)."""
    refuse_grad("ssd_scan", "repro_torch.models.ssm.ssd_chunked",
                (x, dt, A, B, C, initial_state))
    dev = tensor_device(x, device)
    x, dt, A, B, C = (t if isinstance(t, torch.Tensor) else
                      torch.as_tensor(np.asarray(t), device=dev)
                      for t in (x, dt, A, B, C))
    if initial_state is not None and \
            not isinstance(initial_state, torch.Tensor):
        initial_state = torch.as_tensor(np.asarray(initial_state), device=dev)
    _check(x, dt, A, B, C, chunk, initial_state)
    chunk = int(chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    cb, rest, nbytes = ssd_work(b, s, h, p, n, chunk, x.element_size(),
                                groups_of(B))
    with kernel_call("ssd_scan", cb + rest, nbytes):
        if x.device.type == "cpu":
            return ssd_scan_ref(x, dt, A, B, C, chunk=chunk,
                                initial_state=initial_state)
        if x.device.type not in ("cuda", "meta"):
            raise ValueError(f"unsupported device {x.device}")
        return _kernel(x, dt, A, B, C, chunk, initial_state)


def _kernel(x, dt, A, B, C, chunk: int, initial_state):
    """The kernels' checks, outputs and scratch, and on the card the
    launch."""
    _kernel_checks(x, dt, A, B, C, chunk, initial_state)
    b, s, h, p = x.shape
    n, g = B.shape[-1], groups_of(B)
    nc = -(-s // chunk)
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=F32, device=x.device)
    # scratch: per-chunk cumsums, C.B^T per group and chunk, chunk states
    # (then the states entering each chunk, written over them by the carry)
    cum = torch.empty((b, h, nc, chunk), dtype=F32, device=x.device)
    cb = torch.empty((b, g, nc, chunk, chunk), dtype=F32, device=x.device)
    st = torch.empty((b, h, nc, p, n), dtype=F32, device=x.device)
    if x.device.type == "meta":
        return y, state
    from repro_torch.kernels.ssd.build import load
    lib = load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            y.data_ptr(), state.data_ptr(), cum.data_ptr(), cb.data_ptr(),
            st.data_ptr(), b, s, h, p, n, chunk, DTYPES[x.dtype], g, stream)
    if code != 0:
        raise RuntimeError(f"SSD kernel launch failed: CUDA error {code}")
    LAUNCHES["ssd_scan"] += 1
    if x.dtype == torch.bfloat16:
        MMA_LAUNCHES["ssd_scan_mma"] += 1
    return y, state
