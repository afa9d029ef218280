"""Deterministic synthetic LM data pipeline with prefetch and exact resume
— a copy of the JAX package's ``repro.data.pipeline`` (NumPy only; the
port imports nothing of that package).

Tokens follow a noisy affine map ``x_{t+1} = (a x_t + b) mod V`` with
epsilon-uniform corruption — a low-entropy, learnable language, so
training shows real loss curves without external data.  Batch ``i`` is a
pure function of (seed, i): the same ``np.random.default_rng((seed, i))``
stream as the JAX package's, so its batches are byte for byte the same,
and resuming at step i reproduces the exact stream (a checkpoint carries
only the step counter).  Batches stay NumPy on the host; the caller
copies them to the device (``to_device``).

``Prefetcher`` overlaps host-side batch synthesis with device compute via
a background thread and a bounded queue.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    batch: int = 8
    seq: int = 256
    vocab: int = 256
    seed: int = 17
    noise: float = 0.1
    a: int = 31
    b: int = 7


class SyntheticLMData:
    def __init__(self, cfg: DataConfig, model_cfg: Optional[ModelConfig] = None):
        self.cfg = cfg
        self.model_cfg = model_cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        x0 = rng.integers(0, c.vocab, size=(c.batch, 1))
        toks = [x0]
        for _ in range(c.seq):
            nxt = (c.a * toks[-1] + c.b) % c.vocab
            corrupt = rng.random((c.batch, 1)) < c.noise
            rand = rng.integers(0, c.vocab, size=(c.batch, 1))
            toks.append(np.where(corrupt, rand, nxt))
        seq = np.concatenate(toks, axis=1).astype(np.int32)  # [B, S+1]
        out = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        mc = self.model_cfg
        if mc is not None and mc.family == "vlm":
            out["patch_embeds"] = rng.standard_normal(
                (c.batch, mc.n_patches, mc.d_model)).astype(np.float32)
        if mc is not None and mc.family == "encdec":
            out["frames"] = rng.standard_normal(
                (c.batch, c.seq, mc.d_model)).astype(np.float32)
        return out

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(batch: Dict[str, np.ndarray],
              device) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device``: token ids as int64 (the
    index type of torch's gathers), the float stubs as they are."""
    return {k: torch.from_numpy(v).to(
        device, dtype=torch.int64 if v.dtype.kind == "i" else None)
        for k, v in batch.items()}


class Prefetcher:
    """Bounded-queue background prefetch; exceptions propagate on get()."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

        def worker():
            try:
                for item in it:
                    if self._stop.is_set():
                        return
                    self._q.put(item)
            except BaseException as e:  # noqa: BLE001
                self._err = e
                self._q.put(None)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def get(self):
        item = self._q.get()
        if item is None and self._err is not None:
            raise self._err
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
