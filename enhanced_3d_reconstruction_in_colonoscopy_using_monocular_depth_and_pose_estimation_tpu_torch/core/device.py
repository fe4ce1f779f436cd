"""Device selection for the port's entry points, the cache of the device
constants they make, and the alignment test of the kernels' wrappers."""

from __future__ import annotations

import functools

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils._python_dispatch import _disable_current_modes


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; asking for
    it on a machine without a card raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' to run on the CPU")
    return dev


def device_cache(maxsize: int):
    """``functools.lru_cache`` for a function that makes device constants
    (resize matrices and the like). While a fake mode is active (under
    ``torch.export``) the function runs with every dispatch and
    torch-function mode off, so it makes, and caches, real tensors: a
    cached FakeTensor would be returned to every later live call in the
    process, and the traced program takes the real tensor as a constant
    on its device, with no upload at each replay."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            if torch._guards.detect_fake_mode() is None:
                return cached(*args)
            with _disable_current_modes(), torch._C.DisableTorchFunction():
                return cached(*args)

        call.cache_info = cached.cache_info
        call.cache_clear = cached.cache_clear
        return call
    return wrap


def aligned16(x: torch.Tensor) -> bool:
    """Whether the view's base address is 16-byte aligned. A fake tensor
    (tracing) has no address: its storage offset stands in, as the
    allocator aligns every storage."""
    if is_fake(x):
        return x.storage_offset() * x.element_size() % 16 == 0
    return x.data_ptr() % 16 == 0
