"""Row sort on an NVIDIA GPU: the PyTorch/CUDA counterpart of the JAX
package's `pcodec_tpu/ops/pallas_sort.py`.

Training a chunk's bins starts from its latents in ascending order: the
quantile histogram (binning/histogram.py) walks the sorted values. The GPU
encoder's planner (container_encode.plan_encode) sorts each chunk's latents
on the card with K8 (`row_sort`, csrc/row_sort.cu) and walks them on the
host. A sorted multiset is unique, so the bins equal the host sort's.

u64 values travel as int64 tensors holding the same bits. The wrapper takes
its plain PyTorch version only for CPU tensors; for CUDA tensors it launches
the kernel or raises.
"""

import numpy as np
import torch

from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops.container_decode import _MIN64, _check_cuda

M32 = 0xFFFFFFFF


def row_sort_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: each row of x (rows, m) int64, holding u64
    bits, in ascending unsigned order."""
    return torch.sort(x ^ _MIN64, dim=1).values ^ _MIN64


def row_sort(x: torch.Tensor) -> torch.Tensor:
    """K8: each row of x in ascending unsigned order; arguments as
    row_sort_plain. Rows are padded to a power of two with the largest key.
    When every row's span (max - min) fits 32 bits, the kernel sorts u32
    keys relative to the row minimum, else the u64 values; reading that
    choice back is the wrapper's one synchronisation."""
    if x.device.type == "cpu":
        return row_sort_plain(x)
    if x.dim() != 2:
        raise ValueError("row_sort takes a (rows, m) tensor")
    _check_cuda((x, torch.int64))
    rows, m = x.shape
    if rows == 0 or m <= 1:
        return x.clone()
    m_pad = 1 << (m - 1).bit_length()
    xb = x ^ _MIN64
    lo = xb.amin(1)
    span = xb.amax(1) - lo  # negative when the span needs 64 bits
    if bool(((span >= 0) & (span <= M32)).all()):
        lo = (lo ^ _MIN64)[:, None]
        rel = x - lo  # in [0, 2^32)
        keys = torch.full((rows, m_pad), -1, dtype=torch.int32, device=x.device)
        keys[:, :m] = torch.where(rel >= (1 << 31), rel - (1 << 32), rel).to(torch.int32)
        kernels.launch_row_sort(keys)
        return (keys[:, :m].to(torch.int64) & M32) + lo
    keys = torch.full((rows, m_pad), -1, dtype=torch.int64, device=x.device)
    keys[:, :m] = x
    kernels.launch_row_sort(keys)
    return keys[:, :m].contiguous()


def sort_latents(latents: np.ndarray, device) -> np.ndarray:
    """`latents` (any unsigned dtype) in ascending order as uint64, sorted
    on `device` by K8 (its plain version on the CPU)."""
    x = torch.from_numpy(np.ascontiguousarray(latents, dtype=np.uint64).view(np.int64)).to(device)
    return row_sort(x[None])[0].cpu().numpy().view(np.uint64)
