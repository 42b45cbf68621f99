"""The port's hand-written CUDA kernels, one module each.

Every module holds the kernel's wrapper (launches the CUDA kernel for
tensors on the card, the plain PyTorch version for tensors on the CPU, and
raises for anything else), that plain version, and a ``KERNEL`` record
whose ``launches`` counter the wrapper bumps once per kernel launch and
nowhere else — so a run can show that its main path went through the
kernel.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict

import torch

# dtype codes of the C interface (CB_F32, CB_BF16 in csrc/cb_common.cuh)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def walk_grid(capacity: int, sms: int, per_sm: int) -> int:
    """Blocks of a kernel that walks a device-side list of at most
    ``capacity`` entries (i = blockIdx.x, i += gridDim.x while i < count):
    one per entry, at most ``per_sm`` on each of the card's ``sms``
    multiprocessors. 0 for an empty list: nothing is launched."""
    return min(capacity, per_sm * sms)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Multiprocessors of a CUDA device, read once per device."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


@dataclasses.dataclass
class Kernel:
    name: str
    route: str       # "cuda" (nvcc-built C++) or "triton"
    source: str      # repo path of the kernel source
    replaces: str    # file:line of the TPU kernel it ports
    launches: int = 0


from . import (accept, compact_tiles, delta_conv,  # noqa: E402
               delta_conv_detect, delta_pool, detect_full, detect_sparse,
               pool_fused, stem_conv, stem_detect, tma_window)

KERNELS = (detect_sparse.KERNEL, delta_conv.KERNEL, pool_fused.KERNEL,
           stem_detect.KERNEL, stem_conv.KERNEL, delta_conv_detect.KERNEL,
           detect_full.KERNEL, delta_pool.KERNEL, accept.KERNEL,
           tma_window.KERNEL_WRITE, tma_window.KERNEL_READ,
           compact_tiles.KERNEL)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
