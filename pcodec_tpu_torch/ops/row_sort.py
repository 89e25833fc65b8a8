"""Row sort on an NVIDIA GPU: the PyTorch/CUDA counterpart of the JAX
package's `pcodec_tpu/ops/pallas_sort.py`.

Training a chunk's bins starts from its latents in ascending order: the
quantile histogram (binning/histogram.py) walks the sorted values. Device
training (ops/device_train.py) and the GPU encoder's host planner
(container_encode.plan_encode) sort on the card with K8 (`row_sort`,
csrc/row_sort.cu), a segmented LSD radix sort of 8-bit digits. A sorted
multiset is unique, so the bins equal the host sort's.

u64 values travel as int64 tensors holding the same bits. The wrapper takes
its plain PyTorch version only for CPU tensors; for CUDA tensors it launches
the kernel or raises. `row_sort_radix_plain` runs the kernel's own steps in
torch, so the CPU tests hold its digit logic to numpy's sort.
"""

import numpy as np
import torch

from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops.decode import _MIN64, _check_cuda

M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1
MIN32 = -(1 << 31)
RADIX_BITS = 8  # digit of a pass; must match csrc/row_sort.cu
RADIX_TILE = 2048  # keys of a (row, tile) count; must match csrc/row_sort.cu


def radix_plan(span: int) -> tuple:
    """(key bytes, digit passes) of a sort whose largest row span (max - min,
    unsigned) is `span`: u32 keys relative to the row minimum where the span
    fits 32 bits, else u64; a pass for each 8-bit digit below the span's top
    bit, none when every row is one value."""
    return (4 if span <= M32 else 8), -(-span.bit_length() // RADIX_BITS)


def row_sort_u32_plain(keys: torch.Tensor) -> torch.Tensor:
    """Plain version of K8's u32 path: each row of keys (rows, m) int32,
    holding u32 bits, in ascending unsigned order."""
    return torch.sort(keys ^ MIN32, dim=1).values ^ MIN32


def row_sort_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: each row of x (rows, m) int64, holding u64
    bits, in ascending unsigned order."""
    return torch.sort(x ^ _MIN64, dim=1).values ^ _MIN64


def row_sort_radix_plain(x: torch.Tensor) -> torch.Tensor:
    """K8's steps in plain torch, as row_sort_plain: the rows' minima and
    largest span, the key width and pass count that radix_plan takes from
    it, then per 8-bit digit the kernel's stable scatter: each (row, tile)
    of RADIX_TILE keys counted, the counts of a row scanned in (digit, tile)
    order, each key placed at its digit's start in its tile plus its rank
    among the tile's keys of that digit."""
    rows, m = x.shape
    if rows == 0 or m <= 1:
        return x.clone()
    xb = x ^ _MIN64  # unsigned order as int64 order
    lo = xb.amin(1, keepdim=True) ^ _MIN64
    span = max((int(h) - int(l)) & M64 for h, l in zip((xb.amax(1) ^ _MIN64).tolist(), lo[:, 0].tolist()))
    key_bytes, passes = radix_plan(span)
    keys = x - lo  # the u64 difference
    if key_bytes == 4:
        keys = keys.to(torch.int32)  # the same u32 bits
    tiles = -(-m // RADIX_TILE)
    bins = 1 << RADIX_BITS
    pos = torch.arange(m, device=x.device)
    tile = pos // RADIX_TILE
    for p in range(passes):
        d = ((keys >> (RADIX_BITS * p)) & (bins - 1)).to(torch.int64)
        counts = torch.zeros((rows, bins, tiles), dtype=torch.int64, device=x.device)
        counts.view(rows, -1).scatter_add_(1, d * tiles + tile, torch.ones_like(d))
        flat = counts.view(rows, -1)
        gpos = (torch.cumsum(flat, 1) - flat).view(rows, bins, tiles)
        # rank among the keys of the same tile and digit before it: a stable
        # order by (tile, digit) and each key's place in it
        order = torch.argsort(tile * bins + d, dim=1, stable=True)
        first = torch.cumsum(counts.transpose(1, 2).reshape(rows, -1), 1) - counts.transpose(1, 2).reshape(rows, -1)
        place = torch.empty_like(order)
        place.scatter_(1, order, pos.expand(rows, m).contiguous())
        rank = place - first.gather(1, tile * bins + d)
        dest = gpos.view(rows, -1).gather(1, d * tiles + tile) + rank
        keys = torch.empty_like(keys).scatter_(1, dest, keys)
    return (keys.to(torch.int64) & M32 if key_bytes == 4 else keys) + lo


def radix_span(x: torch.Tensor):
    """K8's first kernels on a CUDA tensor x (rows, m): mm (2 rows + 1,)
    int64, each row's minimum and maximum and the largest span, and that
    span read back (the wrapper's one synchronisation)."""
    mm = torch.empty(2 * x.shape[0] + 1, dtype=torch.int64, device=x.device)
    kernels.launch_row_sort_span(x, mm)
    return mm, int(mm[-1]) & M64


def radix_scratch(x: torch.Tensor, key_bytes: int, passes: int):
    """The output, the ping-pong keys (one set for 2 passes, two for more)
    and the (rows, 256, tiles) digit counts of K8's passes over x."""
    rows, m = x.shape
    keys = torch.empty((min(max(passes - 1, 0), 2), rows * m), dtype=torch.int32 if key_bytes == 4 else torch.int64,
                       device=x.device)
    hist = torch.empty(rows * (1 << RADIX_BITS) * -(-m // RADIX_TILE) if passes else 0, dtype=torch.int32,
                       device=x.device)
    return torch.empty_like(x), keys, hist


def _radix_sort(x: torch.Tensor) -> torch.Tensor:
    """K8 on a CUDA tensor (rows, m) of int64 (u64 keys) or int32 (u32
    keys): the rows' minima and span, then the digit passes radix_plan
    gives: a counted span call, then one counted sort call."""
    rows, m = x.shape
    if rows == 0 or m <= 1:
        return x.clone()
    if m >= 1 << 31:
        raise ValueError("row_sort takes rows of fewer than 2^31 keys")
    mm, span = radix_span(x)
    key_bytes, passes = radix_plan(span)
    out, keys, hist = radix_scratch(x, key_bytes, passes)
    kernels.launch_row_sort(x, out, mm, keys, hist, key_bytes, passes)
    return out


def row_sort_u32(keys: torch.Tensor) -> torch.Tensor:
    """K8 on u32 keys as row_sort_u32_plain, into a new tensor; rows of any
    length."""
    if keys.device.type == "cpu":
        return row_sort_u32_plain(keys)
    if keys.dim() != 2:
        raise ValueError("row_sort_u32 takes a (rows, m) tensor")
    _check_cuda((keys, torch.int32))
    return _radix_sort(keys)


def row_sort(x: torch.Tensor) -> torch.Tensor:
    """K8: each row of x in ascending unsigned order, into a new tensor;
    arguments as row_sort_plain, rows of any length. Keys are u32 relative
    to the row minimum when every row's span (max - min) fits 32 bits, else
    u64."""
    if x.device.type == "cpu":
        return row_sort_plain(x)
    if x.dim() != 2:
        raise ValueError("row_sort takes a (rows, m) tensor")
    _check_cuda((x, torch.int64))
    return _radix_sort(x)


def sort_latents(latents: np.ndarray, device) -> np.ndarray:
    """`latents` (any unsigned dtype) in ascending order as uint64, sorted
    on `device` by K8 (its plain version on the CPU)."""
    x = torch.from_numpy(np.ascontiguousarray(latents, dtype=np.uint64).view(np.int64)).to(device)
    return row_sort(x[None])[0].cpu().numpy().view(np.uint64)
