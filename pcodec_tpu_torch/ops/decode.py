"""Plain-PyTorch helpers of the PCT decode and the K3/K4 wrappers.

The counterparts of the XLA helpers in the JAX package's
`pcodec_tpu/ops/decode.py` and of the post-processing of
`pcodec_tpu/ops/pallas_decode.py`:

    bijections        latent <-> memory bits of every number type
    join_mem          the mode joins (Classic, IntMult, FloatQuant, FloatMult)
    dict_join         K4, CUDA (csrc/dict_join.cu): the Dict join, a clamped
                      gather of each entry's memory bits
    consecutive_decode_batched, conv1_decode_pages
                      delta reconstruction in plain torch (XLA in JAX)
    lookback_recon    K3, CUDA (csrc/lookback_recon.cu): per-page lookback
                      reconstruction by pointer doubling

u64 values travel as int64 tensors holding the same bits: add, multiply and
cumsum wrap mod 2^64 exactly; unsigned compares go through `_ult`, logical
right shifts mask after the shift. Each kernel wrapper takes its plain
version only for CPU tensors; for CUDA tensors it launches the kernel or
raises.
"""

import numpy as np
import torch

from pcodec_tpu_torch.dtypes import NumberType
from pcodec_tpu_torch.format.metadata import Mode
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops import softfloat as sf
from pcodec_tpu_torch.ops.softfloat import _MIN64, _i64, _ult  # noqa: F401 (_MIN64 re-exported to the kernel modules)


def _u64_to_tensor(a: np.ndarray, device=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64)).to(device)


def _check_cuda(*pairs):
    dev = pairs[0][0].device
    for t, dtype in pairs:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"kernel argument must be a contiguous {dtype} tensor on {dev}, "
                f"got {t.dtype} on {t.device}"
            )


# ---------------------------------------------------------------------------
# bijections (the JAX `_mask_of`, `_from_latent_ordered_u`)
# ---------------------------------------------------------------------------


def mask_of(bits: int) -> int:
    return _i64((1 << bits) - 1)


def from_latent_ordered(nt: NumberType, lat):
    """latent -> memory bits of the number (the Classic join)."""
    bits = nt.latent.bits
    mask = mask_of(bits)
    lat = lat & mask
    if nt.kind == "unsigned":
        return lat
    mid = _i64(1 << (bits - 1))
    if nt.kind == "signed":
        return (lat ^ mid) & mask
    return torch.where((lat & mid) != 0, lat ^ mid, (~lat) & mask)


def from_latent_ordered_int(nt: NumberType, lat: int) -> int:
    """`from_latent_ordered` of one python int (a mode's scalar)."""
    return int(from_latent_ordered(nt, torch.tensor([_i64(lat)], dtype=torch.int64))[0])


# ---------------------------------------------------------------------------
# mode joins
# ---------------------------------------------------------------------------


def join_mem(nt: NumberType, mode_kind: str, mode_scalar: int, primary, secondary):
    """Mode join -> memory bits of the numbers (int64): the JAX `_join_mem`
    without its Dict branch (dict_join takes that). `mode_scalar` is the
    mode's payload as a python int (base latent, or k for FloatQuant).

    FloatMult multiplies in the integer softfloat for every float width, as
    JAX does for f64 only: the card's native f16/f32 multiply gives other
    bits than the host's (x86) multiply on some inputs (NaN multipliers
    among them), and the decode must give the host's numbers bit for bit."""
    bits = nt.latent.bits
    mask = mask_of(bits)
    if mode_kind == Mode.CLASSIC:
        u_latent = primary & mask
    elif mode_kind == Mode.INT_MULT:
        u_latent = ((primary & mask) * _i64(mode_scalar) + (secondary & mask)) & mask
    elif mode_kind == Mode.FLOAT_QUANT:
        k = int(mode_scalar)
        y = primary & mask
        m = secondary & mask
        sign_cutoff = torch.full_like(y, (1 << (bits - 1)) >> k)
        low_max = ((1 << k) - 1) & ((1 << bits) - 1)
        lowest = torch.where(_ult(y, sign_cutoff), _i64(low_max) - m, m)
        u_latent = ((y << k) + lowest) & mask
    elif mode_kind == Mode.FLOAT_MULT:
        mid = _i64(1 << (bits - 1))
        P = nt.mantissa_digits
        base_bits = torch.full_like(primary, from_latent_ordered_int(nt, mode_scalar))
        mult_bits = sf.int_float_latent_to_bits(primary & mask, bits, bits - P, P)
        unadj_lat = sf.ordered_from_bits(sf.sf_mul_bits(mult_bits, base_bits, bits, bits - P, P), bits)
        u_latent = (unadj_lat + (secondary & mask) + mid) & mask
    else:
        raise NotImplementedError(f"{mode_kind} mode has no join here")
    return from_latent_ordered(nt, u_latent)


def dict_table(nt: NumberType, dict_vals: np.ndarray) -> np.ndarray:
    """Each dictionary entry's memory bits (int64), the latent->memory
    bijection folded in (the JAX `_dict_mem_planes` without its planes)."""
    lat = _u64_to_tensor(np.asarray(dict_vals).astype(np.uint64))
    return from_latent_ordered(nt, lat).numpy()


def dict_join_plain(primary: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: memory bits table[min(primary & 0xFFFFFFFF, D - 1)]."""
    idx = torch.clamp(primary & 0xFFFFFFFF, max=table.shape[0] - 1)
    return table[idx]


def dict_join(primary: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K4: the Dict join. primary (n,) int64 index latents, table (D,) int64
    memory bits -> (n,) int64 memory bits."""
    if primary.device.type == "cpu":
        return dict_join_plain(primary, table)
    if primary.dim() != 1 or table.dim() != 1 or table.shape[0] < 1:
        raise ValueError("dict_join needs a flat primary and a non-empty flat table")
    _check_cuda((primary, torch.int64), (table, torch.int64))
    out = torch.empty_like(primary)
    kernels.launch_dict_join(primary, table, out)
    return out


# ---------------------------------------------------------------------------
# delta reconstruction
# ---------------------------------------------------------------------------


def consecutive_decode_batched(latents, moments, order: int, latent_bits: int):
    """latents (P, N) and moments (P, order), u64 bits in int64; toggle
    center + cascaded exclusive cumsums (the JAX `_consecutive_decode_batched`)."""
    out = latents + _i64(1 << (latent_bits - 1))
    z = torch.zeros((latents.shape[0], 1), dtype=torch.int64, device=latents.device)
    for j in range(order - 1, -1, -1):
        cs = torch.cumsum(out, dim=1)
        out = moments[:, j : j + 1] + torch.cat([z, cs[:, :-1]], dim=1)
    return out


def lookback_rounds(page_n: int) -> int:
    """Pointer-doubling rounds that resolve any page of page_n numbers."""
    return max(page_n - 1, 1).bit_length()


def lookback_decode_pages_plain(latents, lookbacks, moments, window_n: int, state_n: int, bits: int):
    """Plain version of K3: the JAX prologue of `_lookback_decode_pages_pallas`
    plus `xops._lookback_decode`, batched over pages.

    latents (P, N) u64 latents of the var, lookbacks (P, N) the `delta`
    var's latents (only the first N - state_n are read), moments
    (P, state_n) the stored state. Position p < state_n is the stored
    state; after it value[p] = delta[p - state_n] + value[p - lb], lb the
    lookback at p - state_n clipped to [1, window_n], a reference before the
    page reading the zero prefill. Returns (P, N) int64."""
    P, N = latents.shape
    s = min(state_n, N)
    deltas = latents[:, : N - s] + _i64(1 << (bits - 1))
    add = torch.cat([moments[:, :s], deltas], dim=1)
    lb = torch.clamp(lookbacks[:, : N - s], 1, window_n)
    pos = torch.arange(s, N, device=latents.device, dtype=torch.int64)[None, :]
    ptr = torch.cat([torch.full((P, s), -1, dtype=torch.int64, device=latents.device),
                     torch.clamp(pos - lb, min=-1)], dim=1)
    for _ in range(lookback_rounds(N)):
        active = ptr >= 0
        j = torch.clamp(ptr, min=0)
        add = torch.where(active, add + torch.gather(add, 1, j), add)
        ptr = torch.where(active, torch.gather(ptr, 1, j), ptr)
    return add


def lookback_recon(latents, lookbacks, moments, window_n: int, state_n: int, bits: int):
    """K3: per-page lookback reconstruction; arguments as
    lookback_decode_pages_plain. Pages of at most kernels.LB_SMEM_MAX_N
    numbers run in shared memory, one block per page; longer pages run the
    same rounds in global memory, one launch per round."""
    if latents.device.type == "cpu":
        return lookback_decode_pages_plain(latents, lookbacks, moments, window_n, state_n, bits)
    P, N = latents.shape
    if lookbacks.shape != (P, N) or moments.shape != (P, state_n) or window_n < 1 or not 0 < bits <= 64:
        raise ValueError("lookback_recon: argument shapes do not match the pages")
    _check_cuda((latents, torch.int64), (lookbacks, torch.int64), (moments, torch.int64))
    out = torch.empty_like(latents)
    scratch = None
    if N > kernels.LB_SMEM_MAX_N:
        scratch = (torch.empty_like(latents), torch.empty((2, P, N), dtype=torch.int32, device=latents.device))
    kernels.launch_lookback_recon(latents, lookbacks, moments, out, window_n, state_n,
                                  _i64(1 << (bits - 1)), lookback_rounds(N), scratch)
    return out


def conv1_decode_pages(latents, moments, weights, quantization: int, bias: int, order: int, bits: int):
    """`xops._conv1_decode` batched over pages: a loop over positions with
    all pages as the batch. value[p] = delta[p - order] + mid +
    (max(bias + sum_j w_j value[p - order + j], 0) >> quantization) in
    wrapping signed 64-bit arithmetic, masked to `bits`; the first `order`
    outputs are the stored state."""
    P, N = latents.shape
    mid = _i64(1 << (bits - 1))
    mask = mask_of(bits)
    w = torch.tensor(list(weights), dtype=torch.int64, device=latents.device)[None, :]
    out = torch.empty((P, N), dtype=torch.int64, device=latents.device)
    out[:, :order] = moments[:, :order]
    base = latents + mid
    for p in range(order, N):
        s = bias + (w * out[:, p - order : p]).sum(dim=1)
        out[:, p] = (base[:, p - order] + (torch.clamp(s, min=0) >> quantization)) & mask
    out[:, :order] &= mask  # the state itself, unmasked, fed the first predictions
    return out
