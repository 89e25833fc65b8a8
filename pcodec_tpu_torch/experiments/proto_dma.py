"""E1 on a GPU: per-chain fetches into on-chip memory, double-buffered, of
the JAX repository's `experiments/proto_dma.py`.

For tile i and chain ch < 128, with al = starts[i, ch] rounded down to its
1,024-word block and sec_ch = raw[al : al + 3072]:

    acc[r, l] = sum over g < 16, k < 16 of sec_{g*8+r}[k*128 + l]   (int32, wrapping)

then `heavy_rounds` rounds of a <- a + acc[r, a[r, l] & 127] from a = acc,
and out[i] = a, (n_tiles, 8, 128) int32. The kernel fetches all 3,072 words
of each chain and sums the first 2,048, as the prototype does. The TPU
prototype tested the decode's section fetch (one DMA a chain from a
scalar-prefetched offset, the next tile's in flight); here it probes
whether K1 section_gather's copy could fold into K2 chain_decode's load.

    python -m pcodec_tpu_torch.experiments.proto_dma

runs the experiment's (tiles, heavy rounds) on the card: the kernel
(csrc/proto_dma.cu, bulk asynchronous copies completing on mbarriers)
against its plain version bit for bit, and ms a tile and GB/s fetched.
"""

import numpy as np
import torch

from pcodec_tpu_torch.experiments import common
from pcodec_tpu_torch.ops import kernels

N_CHAINS = 128
SEC_WORDS = 2048
FETCH_WORDS = SEC_WORDS + 1024
RAW_WORDS = 32 * 1024 * 1024 // 4
SHAPES = ((16, 0), (64, 0), (256, 0), (64, 512), (256, 512))  # (tiles, heavy rounds)
GROUPS = 16  # chain groups of 8: the kernel's blocks a tile


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as int32 modulo 2^32."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def dma_checksum_plain(starts: torch.Tensor, raw: torch.Tensor, heavy_rounds: int) -> torch.Tensor:
    """Plain version of E1: starts (n_tiles, 128) int32 word offsets, raw
    (n_raw,) int32 -> (n_tiles, 8, 128) int32."""
    n = starts.shape[0]
    al = starts.long() & ~1023
    if bool(((al < 0) | (al + FETCH_WORDS > raw.shape[0])).any()):
        raise ValueError("a chain's fetch lies outside raw")
    sec = raw[al[:, :, None] + torch.arange(SEC_WORDS, device=raw.device)]  # (n, 128, 2048)
    acc = wrap32(sec.view(n, GROUPS, 8, SEC_WORDS // 128, 128).sum(dim=(1, 3)))
    a = acc
    for _ in range(heavy_rounds):
        a = wrap32(a.long() + acc.gather(2, (a & 127).long()).long())
    return a


def dma_checksum(starts: torch.Tensor, raw: torch.Tensor, heavy_rounds: int) -> torch.Tensor:
    """E1: as dma_checksum_plain; on the card a fetch outside raw traps."""
    if raw.device.type == "cpu":
        return dma_checksum_plain(starts, raw, heavy_rounds)
    if raw.dim() != 1 or starts.dim() != 2 or starts.shape[1] != N_CHAINS:
        raise ValueError("dma_checksum takes raw (n_raw,) and starts (n_tiles, 128)")
    for t in (raw, starts):
        if t.device != raw.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"dma_checksum takes contiguous int32 tensors on {raw.device}")
    if raw.data_ptr() % 16:
        raise ValueError("dma_checksum's raw must start on a 16-byte boundary for the bulk copies")
    n = starts.shape[0]
    part = torch.empty((n, GROUPS, 8, 128), dtype=torch.int32, device=raw.device)
    out = torch.empty((n, 8, 128), dtype=torch.int32, device=raw.device)
    kernels.launch_proto_dma(raw, starts, part, out, heavy_rounds)
    return out


def make_inputs(n_tiles: int, device):
    """The experiment's inputs (seed 0): 32 MiB of raw words and one start a
    chain."""
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 2**31, RAW_WORDS, np.int32)
    starts = rng.integers(0, RAW_WORDS - FETCH_WORDS - 1024, (n_tiles, N_CHAINS), np.int32)
    return torch.from_numpy(starts).to(device), torch.from_numpy(raw).to(device)


def needed_words(starts: torch.Tensor, n_raw: int) -> int:
    """Distinct words of raw the function sums: the union of each chain's
    first SEC_WORDS words from its aligned start."""
    al = starts.long().flatten() & ~1023
    edges = torch.zeros(n_raw + 1, dtype=torch.int32, device=starts.device)
    one = torch.ones_like(al, dtype=torch.int32)
    edges.index_add_(0, al, one)
    edges.index_add_(0, al + SEC_WORDS, -one)
    return int((edges.cumsum(0) > 0).sum())


def measure(n_tiles: int, heavy_rounds: int, device="cuda") -> dict:
    """The kernel against its plain version at (n_tiles, heavy_rounds), on
    the card. Bound: the distinct words of raw the function sums (each read
    once), the starts and the output; the sums' adds and the rounds' 3
    operations a step. The kernel fetches more (3,072 words a chain, words
    that several chains share fetched again), mostly from L2: raw (32 MiB)
    fits the card's 50 MB L2."""
    dev = common.cuda_device(device)
    n0 = kernels.LAUNCHES["proto_dma"]
    starts, raw = make_inputs(n_tiles, dev)
    out = dma_checksum(starts, raw, heavy_rounds)
    common.check_equal(out, dma_checksum_plain(starts, raw, heavy_rounds),
                       f"proto_dma ({n_tiles} tiles, {heavy_rounds} heavy rounds)")
    t = common.kernel_ms(lambda: dma_checksum(starts, raw, heavy_rounds))
    plain = common.time_plain_ms(lambda: dma_checksum_plain(starts, raw, heavy_rounds))
    needed = needed_words(starts, raw.shape[0]) * 4
    fetched = n_tiles * N_CHAINS * FETCH_WORDS * 4
    ops = n_tiles * N_CHAINS * SEC_WORDS + out.numel() * heavy_rounds * 3
    return common.row("proto_dma", f"{n_tiles} tiles, heavy {heavy_rounds}", kernels.LAUNCHES["proto_dma"] - n0,
                      t, plain[0], None, common.bound(needed + common.nbytes(starts, out), ops),
                      f"{t[1] / n_tiles * 1e3:.2f} us/tile, {fetched / 1e6 / t[1]:.1f} GB/s DMA (card alone; "
                      f"{fetched / 1e6:.1f} MB fetched, mostly from L2; {needed / 1e6:.1f} MB of distinct words "
                      f"needed)")


def main(device="cuda") -> list:
    """The experiment's shapes on the card, printed; returns their rows."""
    common.cuda_device(device)
    card = common.card_line()
    return [common.report("E1", measure(n_tiles, heavy, device), card) for n_tiles, heavy in SHAPES]


if __name__ == "__main__":
    main()
