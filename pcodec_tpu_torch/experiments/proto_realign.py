"""E5 on a GPU: the section realign copy of the JAX repository's
`experiments/proto_realign.py`.

    out[g, t, s, :] = raw2d[starts_blk[g * 8 + s] * 8 + t, :]   for t < 24

Each chain (g, s) fetches 3 aligned 1,024-word blocks (24 rows of 128
words) at a block index; the output lays them out (group, row, chain, 128).
The TPU prototype tested that layout for the decode's section fetch. Here it
probes K1 section_gather (csrc/section_gather.cu), which copies each chain's
words chain-major instead: both are copies bound by bytes.

    python -m pcodec_tpu_torch.experiments.proto_realign

runs the experiment's shapes (256 and 2,048 groups over a 64 MiB table) on
the card: the kernel (csrc/proto_realign.cu) against its plain version bit
for bit, then the kernel, the plain version and one `index_select` timed.
"""

import numpy as np
import torch

from pcodec_tpu_torch.experiments import common
from pcodec_tpu_torch.ops import kernels

FETCH_BLOCKS = 3  # 1,024-word aligned blocks a chain
FETCH_ROWS = FETCH_BLOCKS * 8
N_ROWS = 1 << 17  # 64 MiB of raw words
GROUP_COUNTS = (256, 2048)


def realign_plain(starts_blk: torch.Tensor, raw2d: torch.Tensor) -> torch.Tensor:
    """Plain version of E5: starts_blk (n_groups * 8,) int32 block indices,
    raw2d (n_rows, 128) int32 -> (n_groups, 24, 8, 128) int32."""
    rows = starts_blk.view(-1, 8).long()[:, :, None] * 8 + torch.arange(FETCH_ROWS, device=raw2d.device)
    return raw2d[rows].permute(0, 2, 1, 3).contiguous()


def realign(starts_blk: torch.Tensor, raw2d: torch.Tensor) -> torch.Tensor:
    """E5: as realign_plain; on the card a block index outside
    [0, n_rows / 8 - 3] traps."""
    if raw2d.device.type == "cpu":
        return realign_plain(starts_blk, raw2d)
    if raw2d.dim() != 2 or raw2d.shape[1] != 128 or starts_blk.dim() != 1 or starts_blk.shape[0] % 8:
        raise ValueError("realign takes raw2d (n_rows, 128) and starts_blk (n_groups * 8,)")
    for t in (raw2d, starts_blk):
        if t.device != raw2d.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"realign takes contiguous int32 tensors on {raw2d.device}")
    out = torch.empty((starts_blk.shape[0] // 8, FETCH_ROWS, 8, 128), dtype=torch.int32, device=raw2d.device)
    kernels.launch_proto_realign(raw2d, starts_blk, out)
    return out


def make_inputs(n_groups: int, device):
    """The experiment's inputs (seed 0): a 64 MiB raw table and one block
    index a chain."""
    rng = np.random.default_rng(0)
    raw2d = rng.integers(0, 2**31, (N_ROWS, 128), dtype=np.int32)
    starts = rng.integers(0, N_ROWS // 8 - FETCH_BLOCKS, n_groups * 8, dtype=np.int32)
    return torch.from_numpy(starts).to(device), torch.from_numpy(raw2d).to(device)


def measure(n_groups: int, device="cuda") -> dict:
    """The kernel against its plain version and `index_select` (over an
    index built untimed) at n_groups, on the card. Bound: the output written
    once and the distinct rows of raw2d it copies read once (chains' blocks
    overlap, and 2,048 groups read most of the 64 MiB table)."""
    dev = common.cuda_device(device)
    n0 = kernels.LAUNCHES["proto_realign"]
    st, raw2d = make_inputs(n_groups, dev)
    out = realign(st, raw2d)
    common.check_equal(out, realign_plain(st, raw2d), f"proto_realign ({n_groups} groups)")
    idx = (st.view(-1, 1, 8).long() * 8 + torch.arange(FETCH_ROWS, device=dev).view(1, -1, 1)).flatten()
    if not torch.equal(raw2d.index_select(0, idx).view(out.shape), out):
        raise AssertionError("E5's index_select yardstick computes another function")
    t = common.kernel_ms(lambda: realign(st, raw2d))
    plain = common.time_plain_ms(lambda: realign_plain(st, raw2d))
    lib = common.time_ms(lambda: raw2d.index_select(0, idx))
    read = int(torch.unique(idx).numel()) * 128 * 4
    out_b = common.nbytes(out)
    return common.row("proto_realign", f"{n_groups} groups", kernels.LAUNCHES["proto_realign"] - n0, t, plain[0],
                      lib[0], common.bound(out_b + read + common.nbytes(st)),
                      f"{out_b / 1e6 / t[1]:.1f} GB/s realigned (card alone; {out_b / 1e6:.1f} MB written, "
                      f"{read / 1e6:.1f} MB of distinct rows read)")


def main(device="cuda") -> list:
    """The experiment's shapes on the card, printed; returns their rows."""
    common.cuda_device(device)
    card = common.card_line()
    return [common.report("E5", measure(n_groups, device), card) for n_groups in GROUP_COUNTS]


if __name__ == "__main__":
    main()
