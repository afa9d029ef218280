"""PyTorch/CUDA port of the false-negative-aware cache simulator, its
router tier and the LM serving path.

The package mirrors the JAX reference ``repro`` module for module and
imports nothing of it (nor of JAX).  What is NumPy or plain Python in the
reference stays so here — it is the oracle's own arithmetic — and every
jitted or Pallas piece is torch on the device or a kernel written for
Hopper (``repro_torch.kernels``).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"`` (``repro_torch.device``).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
