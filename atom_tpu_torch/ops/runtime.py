"""Device policy and kernel dispatch.

* Entry points resolve their device with :func:`resolve_device`: ``cuda``
  unless the caller asks for the CPU; no card and no explicit CPU raises.
* A kernel wrapper calls :func:`on_cpu` on its inputs: CPU tensors take the
  plain PyTorch version, CUDA tensors launch the kernel; anything else (a
  mix, another device) raises.  There is no fallback from the kernel.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the plain PyTorch versions"
            )
        return torch.device("cuda")
    return torch.device(device)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU, False if every one is on CUDA."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs must all be on the CPU or all on CUDA, got {kinds}")


def check_kernel_input(t: torch.Tensor, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous 16-byte-aligned CUDA tensor of
    ``dtype`` (and ``shape``) — what the kernels' raw pointers assume."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")
