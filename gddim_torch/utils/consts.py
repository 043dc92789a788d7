"""Host constants on a device, made once."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _cached(data: bytes, np_dtype: str, shape: tuple, dtype, device) -> torch.Tensor:
    arr = np.frombuffer(data, dtype=np_dtype).reshape(shape)
    with torch.inference_mode(False):  # a normal tensor, usable where autograd records
        return torch.as_tensor(arr.copy(), dtype=dtype, device=device)


def device_constant(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.as_tensor(arr, dtype=dtype, device=device)`` made once per
    value, dtype and device, so that a computation that needs it copies
    nothing from the host after its first call (and a CUDA graph can hold
    it). The tensor is shared: callers must not write to it."""
    arr = np.ascontiguousarray(arr)
    return _cached(arr.tobytes(), arr.dtype.str, arr.shape, dtype, torch.device(device))
