"""Kernels written by hand for Hopper (sm_90a), each beside its plain
PyTorch version; ``ops`` picks one by the device of its inputs."""
import torch


def refuse_grad(kernel: str, instead: str, tensors) -> None:
    """Raise ``ValueError`` if gradients are enabled and any of
    ``tensors`` requires one: the kernels have no backward, so their
    outputs would carry none and a gradient through them would be
    silently missing.  Raised on every device, the CPU included (where
    the plain version could differentiate), so that CPU tests catch a
    training path that strays onto a kernel."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise ValueError(
            f"{kernel} has no backward (the kernel's output carries no "
            f"gradient); differentiate through {instead} instead, or call "
            f"it under torch.no_grad()")
