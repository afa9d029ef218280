"""Public wrappers for the Bloom-probe kernel.

``bloom_probe`` answers, for a batch of keys and n byte-packed indicator
bitmaps, whether all k probed bits are set: [B, n] int8 indications, the
router's input to ``core.batched.cs_fna_batched``/``cs_fno_batched``.
``build_indicator`` makes one such bitmap from a key set with torch ops (a
scatter; the JAX package has no kernel for it either).

Dispatch is by the device of the tensors: a CUDA tensor launches the
hand-written kernel (``csrc/bloom.cu``, built at first use by ``build.py``)
or raises on a dtype, shape or layout the kernel does not take; a CPU
tensor takes the plain version (``ref.py``).  NumPy or list inputs are
placed on ``device`` first, which defaults to ``cuda`` (and raises without
a GPU).  The TPU wrapper's ``use_pallas``/``interpret`` knobs and its
``m_bytes % 2048`` tiling rule have no counterpart: any ``m_bytes >= 1``
with ``8 * m_bytes < 2^32`` is taken.

``LAUNCHES`` counts kernel launches (the plain path counts nothing).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import I64, DeviceLike, tensor_device
from repro_torch.kernels.bloom import ref

#: kernel launches since the last ``reset_launches()``
LAUNCHES = {"bloom_probe": 0}
#: keys hashed per scatter step of ``build_indicator`` (bounds its
#: [keys, k] int64 working set near 320 MB at k = 10)
BUILD_CHUNK = 1 << 22
KEY_DTYPES = (torch.int32, torch.int64)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _keys_on(keys, dev: torch.device) -> torch.Tensor:
    if isinstance(keys, torch.Tensor):
        if keys.device != dev:
            raise ValueError(f"keys lie on {keys.device}, bits on {dev}")
        return keys
    keys = np.asarray(keys)
    if keys.dtype.kind == "u":      # uint32 keys: same low 32 bits in int64
        keys = keys.astype(np.int64)
    return torch.as_tensor(keys, device=dev)


def build_indicator(keys, m: int, k: int, seed: int = 0, *,
                    device: DeviceLike = None) -> torch.Tensor:
    """Byte-packed bitmap [m / 8] uint8 of a key set (m % 8 == 0), on the
    keys' device (or ``device``); equal to ``ref.build_indicator_ref``,
    hashed in chunks of ``BUILD_CHUNK`` keys."""
    dev = tensor_device(keys, device)
    keys = _keys_on(keys, dev).reshape(-1)
    if m % 8:
        raise ValueError(f"m must be a multiple of 8, got {m}")
    bits01 = torch.zeros(m, dtype=torch.uint8, device=dev)
    for lo in range(0, keys.shape[0], BUILD_CHUNK):
        idx = ref.hash_idx(keys[lo:lo + BUILD_CHUNK], k, m, seed)
        bits01[idx.reshape(-1)] = 1
    return ref.pack_bits(bits01)


def _check(code: int) -> None:
    if code != 0:
        raise RuntimeError(f"Bloom-probe kernel launch failed: CUDA error "
                           f"{code}")


def bloom_probe(bits, keys, *, k: int, seeds=None,
                device: DeviceLike = None) -> torch.Tensor:
    """[B, n] int8 indications of keys [B] against bitmaps [n, m_bytes]
    uint8, k probes each; ``seeds`` [n] per-cache hash seeds (Python ints
    or an array; default 0 .. n-1)."""
    dev = tensor_device(bits, device)
    if not isinstance(bits, torch.Tensor):
        bits = torch.as_tensor(np.asarray(bits, np.uint8), device=dev)
    keys = _keys_on(keys, dev)
    if bits.dim() != 2 or keys.dim() != 1:
        raise ValueError(f"bits must be [n, m_bytes] and keys [B], got "
                         f"{tuple(bits.shape)} and {tuple(keys.shape)}")
    n, mbytes = bits.shape
    if not 1 <= mbytes < 1 << 29:          # m = 8 * m_bytes < 2^32
        raise ValueError(f"m_bytes must be in [1, 2^29), got {mbytes}")
    if int(k) < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    seeds = list(range(n)) if seeds is None else \
        [int(s) for s in np.asarray(seeds).reshape(-1)]
    if len(seeds) != n:
        raise ValueError(f"{len(seeds)} seeds for {n} bitmaps")
    if dev.type == "cpu":
        return ref.bloom_probe_ref(bits, keys, int(k), seeds)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if bits.dtype != torch.uint8 or not bits.is_contiguous():
        raise ValueError(f"bits must be contiguous uint8, got {bits.dtype}"
                         f"{'' if bits.is_contiguous() else ' (strided)'}")
    if keys.dtype not in KEY_DTYPES or not keys.is_contiguous():
        raise ValueError(f"keys must be contiguous int32 or int64, got "
                         f"{keys.dtype}"
                         f"{'' if keys.is_contiguous() else ' (strided)'}")
    b = keys.shape[0]
    out = torch.empty((b, n), dtype=torch.int8, device=dev)
    if b == 0 or n == 0:
        return out
    words = torch.tensor([ref.seed_word(s) for s in seeds], dtype=I64,
                         device=dev)
    from repro_torch.kernels.bloom.build import load
    lib = load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check(lib.bloom_probe(bits.data_ptr(), n, mbytes, words.data_ptr(),
                               keys.data_ptr(),
                               int(keys.dtype == torch.int64), b, int(k),
                               out.data_ptr(), stream))
    LAUNCHES["bloom_probe"] += 1
    return out
