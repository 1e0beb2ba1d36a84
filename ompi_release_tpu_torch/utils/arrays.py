"""Host values and tensors: the conversions the one-sided plane, SHMEM and
file IO share.

The JAX package takes a caller's buffer with ``jnp.asarray``: a copy at
call time, and with 64-bit types off a float64 or int64 host value
becomes float32 or int32. :func:`copy_to` does the same for host values,
so a caller that reuses its numpy buffer after the call, or passes a
Python float to a bf16 window, gets the JAX package's bits. A tensor
keeps its dtype (the port carries 64-bit types) and is copied too: the
port's tensors are mutable where JAX's arrays are not.
"""

from __future__ import annotations

import numpy as np
import torch

#: what ``jnp.asarray`` makes of a 64-bit host value with x64 off
_CANONICAL = {np.dtype(np.float64): np.dtype(np.float32),
              np.dtype(np.int64): np.dtype(np.int32),
              np.dtype(np.uint64): np.dtype(np.uint32),
              np.dtype(np.complex128): np.dtype(np.complex64)}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or its name
    (``"bfloat16"`` included)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def numpy_name(dtype: torch.dtype) -> str:
    """The numpy name of a torch dtype (``"bfloat16"`` for bf16)."""
    if dtype is torch.bfloat16:
        return "bfloat16"
    return str(torch.empty(0, dtype=dtype).numpy().dtype)


def host_tensor(x) -> torch.Tensor:
    """A CPU tensor copy of a host value, converted as ``jnp.asarray``
    would (64-bit types to 32-bit)."""
    arr = np.asarray(x)
    arr = np.array(arr.astype(_CANONICAL.get(arr.dtype, arr.dtype),
                              copy=False), copy=True, order="C")
    if arr.dtype.name == "bfloat16":  # ml_dtypes: no torch from_numpy
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def copy_to(x, device) -> torch.Tensor:
    """A tensor on ``device`` holding ``x``'s value now, sharing no
    memory with it."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    return host_tensor(x).to(device)  # a fresh copy already on the CPU


def to_numpy(t) -> np.ndarray:
    """A C-ordered host numpy array of a tensor (bf16 widened to f32,
    which holds every bf16 value exactly; it may share memory with a CPU
    tensor); numpy values pass through."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach()
    if t.dtype is torch.bfloat16:
        t = t.float()
    return t.cpu().contiguous().numpy()
