"""Device resolution for the port's entry points, and the one
conversion of host arrays into device tensors."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on.

    "cuda" (the default) requires a visible CUDA device and raises
    otherwise: the port never carries on quietly on the CPU. Pass
    "cpu" explicitly to run the plain PyTorch versions (the tests do).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


# the dtypes JAX gives host values with x64 off (the JAX package never
# turns it on): 64-bit types become their 32-bit counterparts
_X64_OFF = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
            np.dtype(np.uint64): np.uint32,
            np.dtype(np.complex128): np.complex64}
_X64_OFF_TORCH = {torch.float64: torch.float32, torch.int64: torch.int32}


def to_device(x, device) -> torch.Tensor:
    """A host value (numpy array, Python scalar or sequence, or tensor)
    as a tensor on `device`, cast as `jnp.asarray` casts it with x64
    off: float64 -> float32, int64 -> int32 (wrapping), uint64 ->
    uint32. Every numpy array the coordinator hands to the ops comes
    through here, so an f64 array gives the JAX package's f32 result."""
    dev = torch.device(device) if not isinstance(device, torch.device) \
        else device
    if isinstance(x, torch.Tensor):
        dt = _X64_OFF_TORCH.get(x.dtype)
        return x.to(device=dev, dtype=dt) if dt is not None else x.to(dev)
    a = np.asarray(x)
    to = _X64_OFF.get(a.dtype)
    if to is not None:
        a = a.astype(to)
    # a pageable copy the host has staged when `to` returns: no sync
    return torch.as_tensor(a).to(dev, non_blocking=True)
