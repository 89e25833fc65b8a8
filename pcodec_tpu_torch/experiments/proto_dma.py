"""E1 on a GPU: the section checksum of the JAX repository's
`experiments/proto_dma.py`, computed from column sums of raw's blocks.

For tile i and chain ch < 128, with al = starts[i, ch] rounded down to its
1,024-word block and sec_ch = raw[al : al + 3072]:

    acc[r, l] = sum over g < 16, k < 16 of sec_{g*8+r}[k*128 + l]   (int32, wrapping)

then `heavy_rounds` rounds of a <- a + acc[r, a[r, l] & 127] from a = acc,
and out[i] = a, (n_tiles, 8, 128) int32. A section outside raw is refused
(al < 0 or al + 3072 > n_raw), though only its first 2,048 words are
summed.

The TPU prototype tested the decode's section fetch: one DMA a chain from a
scalar-prefetched offset into VMEM, the next tile's in flight. The kernel
here (csrc/proto_dma.cu) fetches no section. A section sums exactly two
whole blocks, so a first pass writes the blocks' 128 column sums, each
word of a block read once: of every whole block of raw, or, where the
chains touch fewer blocks than raw holds, of each block a chain touches
(`colsum_rows`). Then a block a tile adds its chains' rows of those sums
and runs the rounds by route lane's pointer doubling
(`micro_gather.lane_steps_doubling_plain`); `dma_checksum_blocks_plain` is
that structure in torch. The fetch form, the earlier kernel (a bulk copy
of each chain's 3,072 words into shared memory, double-buffered), is
timed against it from an earlier tree by `tools/torch_kernel_variants.py
--only e1 --parent DIR`.

    python -m pcodec_tpu_torch.experiments.proto_dma

runs the experiment's (tiles, heavy rounds) on the card: the kernel
against its plain version bit for bit, ms a tile, and its two kernels'
device times a call (torch.profiler) beside the bytes each reads.
"""

import numpy as np
import torch

from pcodec_tpu_torch.experiments import common, micro_gather
from pcodec_tpu_torch.ops import kernels

N_CHAINS = 128
BLOCK_WORDS = 1024  # the blocks whose column sums the kernel sums
SEC_WORDS = 2 * BLOCK_WORDS
FETCH_WORDS = SEC_WORDS + BLOCK_WORDS
RAW_WORDS = 32 * 1024 * 1024 // 4
SHAPES = ((16, 0), (64, 0), (256, 0), (64, 512), (256, 512))  # (tiles, heavy rounds)
GROUPS = 16  # chain groups of 8 in a tile


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as int32 modulo 2^32."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _aligned_starts(starts: torch.Tensor, n_raw: int) -> torch.Tensor:
    """Each chain's start rounded down to its block; raises where its
    section lies outside raw."""
    al = starts.long() & ~(BLOCK_WORDS - 1)
    if bool(((al < 0) | (al + FETCH_WORDS > n_raw)).any()):
        raise ValueError("a chain's fetch lies outside raw")
    return al


def dma_checksum_plain(starts: torch.Tensor, raw: torch.Tensor, heavy_rounds: int) -> torch.Tensor:
    """Plain version of E1: starts (n_tiles, 128) int32 word offsets, raw
    (n_raw,) int32 -> (n_tiles, 8, 128) int32."""
    n = starts.shape[0]
    al = _aligned_starts(starts, raw.shape[0])
    sec = raw[al[:, :, None] + torch.arange(SEC_WORDS, device=raw.device)]  # (n, 128, 2048)
    acc = wrap32(sec.view(n, GROUPS, 8, SEC_WORDS // 128, 128).sum(dim=(1, 3)))
    a = acc
    for _ in range(heavy_rounds):
        a = wrap32(a.long() + acc.gather(2, (a & 127).long()).long())
    return a


def colsum_rows(n_tiles: int, n_raw: int) -> tuple:
    """(route, rows) of the column-sum pass, as csrc/proto_dma.cu chooses
    them: a row a block touch ("touched blocks", 2 a chain) where the
    chains touch fewer blocks than raw holds, else every whole block of raw
    ("every block")."""
    touches, n_blocks = 2 * N_CHAINS * n_tiles, n_raw // BLOCK_WORDS
    return ("touched blocks", touches) if touches < n_blocks else ("every block", n_blocks)


def block_column_sums_plain(raw: torch.Tensor, blocks=None) -> torch.Tensor:
    """C[b, l] = sum over k < 8 of raw[1024 b + 128 k + l] for every whole
    block b of raw, or only for the blocks listed in `blocks` (the other
    rows 0): (n_raw >> 10, 128) int32, wrapping."""
    n_blocks = raw.shape[0] // BLOCK_WORDS
    whole = raw[: n_blocks * BLOCK_WORDS].view(n_blocks, 8, 128)
    if blocks is None:
        return wrap32(whole.long().sum(1))
    colsum = torch.zeros((n_blocks, 128), dtype=torch.int32, device=raw.device)
    colsum[blocks] = wrap32(whole[blocks].long().sum(1))
    return colsum


def dma_checksum_blocks_plain(starts: torch.Tensor, raw: torch.Tensor, heavy_rounds: int) -> torch.Tensor:
    """The kernel's structure in torch, the function of dma_checksum_plain:
    the blocks' column sums on the kernel's route (`colsum_rows`: every
    block, or only those the chains touch), each tile's rows of them (a
    section is blocks b and b + 1), then the rounds by route lane's pointer
    doubling with tbl = idx = acc."""
    n = starts.shape[0]
    b = _aligned_starts(starts, raw.shape[0]) // BLOCK_WORDS
    touched = torch.stack((b, b + 1)).flatten() if colsum_rows(n, raw.shape[0])[0] == "touched blocks" else None
    colsum = block_column_sums_plain(raw, touched).long()
    acc = wrap32((colsum[b] + colsum[b + 1]).view(n, GROUPS, 8, 128).sum(1)).view(n * 8, 128)
    return micro_gather.lane_steps_doubling_plain(acc, acc, heavy_rounds).view(n, 8, 128)


def dma_checksum(starts: torch.Tensor, raw: torch.Tensor, heavy_rounds: int) -> torch.Tensor:
    """E1: as dma_checksum_plain; on the card a section outside raw traps."""
    if raw.device.type == "cpu":
        return dma_checksum_plain(starts, raw, heavy_rounds)
    if raw.dim() != 1 or starts.dim() != 2 or starts.shape[1] != N_CHAINS:
        raise ValueError("dma_checksum takes raw (n_raw,) and starts (n_tiles, 128)")
    for t in (raw, starts):
        if t.device != raw.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"dma_checksum takes contiguous int32 tensors on {raw.device}")
    if raw.data_ptr() % 16:
        raise ValueError("dma_checksum's raw must start on a 16-byte boundary for the 16-byte loads")
    colsum = torch.empty((raw.shape[0] // BLOCK_WORDS, 128), dtype=torch.int32, device=raw.device)
    out = torch.empty((starts.shape[0], 8, 128), dtype=torch.int32, device=raw.device)
    kernels.launch_proto_dma(raw, starts, colsum, out, heavy_rounds)
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
    the card, and its two kernels' device times a call from the profiler's
    trace (`common.kernel_split_ms`) beside the bytes each reads by count
    (computed from the inputs, not measured). `launches` counts the check
    and the timed calls; `traced_launches` the calls the profiler traced.
    Bound: the distinct words of raw the function sums (each read once),
    the starts and the output; the sums' adds and the rounds' 3 operations
    a step. The kernel reads each block of its column-sum route once a row,
    then each chain's two rows of column sums (1 KB a chain): raw (32 MiB)
    and its sums (4 MiB) fit the card's 50 MB L2."""
    dev = common.cuda_device(device)
    n0 = kernels.LAUNCHES["proto_dma"]
    starts, raw = make_inputs(n_tiles, dev)
    out = dma_checksum(starts, raw, heavy_rounds)
    common.check_equal(out, dma_checksum_plain(starts, raw, heavy_rounds),
                       f"proto_dma ({n_tiles} tiles, {heavy_rounds} heavy rounds)")
    t = common.kernel_ms(lambda: dma_checksum(starts, raw, heavy_rounds))
    launches = kernels.LAUNCHES["proto_dma"] - n0
    split = common.kernel_split_ms(lambda: dma_checksum(starts, raw, heavy_rounds), ("colsum_kernel", "tile_kernel"))
    traced = kernels.LAUNCHES["proto_dma"] - n0 - launches
    plain = common.time_plain_ms(lambda: dma_checksum_plain(starts, raw, heavy_rounds))
    needed = needed_words(starts, raw.shape[0]) * 4
    route, rows = colsum_rows(n_tiles, raw.shape[0])
    colsum_read = rows * BLOCK_WORDS * 4
    tile_read = n_tiles * N_CHAINS * 2 * 128 * 4 + common.nbytes(starts)
    ops = n_tiles * N_CHAINS * SEC_WORDS + out.numel() * heavy_rounds * 3
    colsum_ms, tile_ms = split["colsum_kernel"], split["tile_kernel"]
    held = "" if None not in (colsum_ms, tile_ms) else f" (the trace held {split['held']})"
    return common.row("proto_dma", f"{n_tiles} tiles, heavy {heavy_rounds}", launches,
                      t, plain[0], None, common.bound(needed + common.nbytes(starts, out), ops),
                      f"{t[1] / n_tiles * 1e3:.2f} us/tile (card alone); its kernels a call (profiler, "
                      f"{split['tries']} trace(s), {traced} launches): colsum_kernel {_ms(colsum_ms)} on {route}, {rows} rows, "
                      f"reading {colsum_read / 1e6:.1f} MB of raw, tile_kernel {_ms(tile_ms)} reading "
                      f"{tile_read / 1e6:.1f} MB of column-sum rows and starts (bytes counted){held}; "
                      f"{micro_gather.lane_rounds(heavy_rounds)} rounds of pointer doubling; "
                      f"{needed / 1e6:.1f} MB of distinct words needed",
                      colsum_ms=colsum_ms, tile_ms=tile_ms, colsum_route=route, traced_launches=traced)


def _ms(ms) -> str:
    return "not in the trace" if ms is None else f"{ms:.4f} ms"


def main(device="cuda") -> list:
    """The experiment's shapes on the card, printed; returns their rows."""
    common.cuda_device(device)
    card = common.card_line()
    return [common.report("E1", measure(n_tiles, heavy, device), card) for n_tiles, heavy in SHAPES]


if __name__ == "__main__":
    main()
