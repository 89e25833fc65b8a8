"""E3 and E4a on a GPU: the table-lookup strategies of the JAX repository's
`experiments/micro_gather.py` and the one-gather check of
`experiments/proto_round_loop.py`.

Four routes of one kernel source (csrc/micro_gather.cu), one thread per
dependent chain:

    gather_take  STEPS rounds of idx <- (idx + table[row * TS + idx]) & (TS - 1)
                 on idx (T, 4) from the flat table, each block's rows (up
                 to 4) bulk-copied into shared memory, a row on its own
                 barrier, each warp walking once its rows land; rows larger
                 than a block's shared memory (TS from 2^16) walk through
                 the read-only path (`take_route`)
    gather_taa   the same function, a warp a row (TAA_WARPS warps a block),
                 each warp staging its row by 16-byte cp.async copies and
                 walking once its lanes have met at __syncwarp, no block
                 barrier (`gather_taa_warps_plain`); rows larger than a
                 block's shared memory are refused
    gather_lane  LSTEPS rounds of idx <- idx + tbl[r, idx & 127] on (8, 128),
                 by pointer doubling (ceil(log2(LSTEPS + 1)) rounds), a
                 warp a row, the table held in registers and read by
                 __shfl_sync
    gather_row   one take_along_axis(tbl, idx, axis=1): out[r, l] = tbl[r, idx[r, l]],
                 the row's words and its indices loaded together, then
                 gathered on chip: a warp a row in registers up to
                 ROW_LANE_MAX words (`row_gather_lanes_plain`); wider rows
                 a thread an element (`row_route`)

All int32 with wrap-around. They probe where K2 chain_decode keeps its
node/lower table (shared memory) and K4 dict_join's two table routes: every
lookup's address depends on the lookup before, so latency, not bytes, sets
the time.

The experiment's XLA variants (a gather and a take_along_axis in a scan, a
one-hot bf16 matrix product) are not Pallas kernels; they run here as plain
PyTorch loops, timed as yardsticks (`xla_variants`).

    python -m pcodec_tpu_torch.experiments.micro_gather

runs the experiment's shapes (T = 2,048, TS = 1,024, STEPS = 192, LSTEPS =
6,144) on the card: each route against its plain version bit for bit, M
lookups/s (route lane: the function's chain-steps a second and the rounds
its pointer doubling took), and one row's time alone (route take: also its
rows a block and the route that ran).
"""

import numpy as np
import torch

from pcodec_tpu_torch.experiments import common
from pcodec_tpu_torch.ops import kernels

T = 2048  # rows (the experiment's lanes), 4 chains each
STEPS = 192
TS = 1024  # table entries a row
LSTEPS = STEPS * 32
OPS_PER_LOOKUP = 3  # index arithmetic, lookup, add/mask
TAKE_ROWS = 4  # rows a block route take stages in shared memory at most; must match csrc/micro_gather.cu
TAA_WARPS = 4  # warps (a row each) a block of route taa at most; must match csrc/micro_gather.cu
ROW_LANE_MAX = 128  # widest row route row holds in a warp's registers; must match csrc/micro_gather.cu


def gather_steps_plain(table: torch.Tensor, idx0: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version of routes take and taa: table (rows, ts) or its flat
    (rows * ts,) view, idx0 (rows, 4) int32 in [0, ts) -> (rows, 4) int32."""
    rows = idx0.shape[0]
    ts = table.numel() // rows
    flat = table.reshape(-1)
    off = torch.arange(rows, device=idx0.device)[:, None] * ts
    idx = idx0.long()
    for _ in range(steps):
        idx = (idx + flat[off + idx].long()) & (ts - 1)
    return idx.to(torch.int32)


def lane_steps_plain(tbl: torch.Tensor, idx: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version of route lane: tbl, idx (rows, 128) int32."""
    x = idx.long()
    for _ in range(steps):
        x = _wrap32(x + tbl.gather(1, x & 127).long())
    return x.to(torch.int32)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def lane_rounds(steps: int) -> int:
    """Rounds of route lane's pointer doubling: ceil(log2(steps + 1)), the
    bits of `steps`."""
    return int(steps).bit_length()


def lane_steps_doubling_plain(tbl: torch.Tensor, idx: torch.Tensor, steps: int) -> torch.Tensor:
    """Route lane's kernel in torch: the function of lane_steps_plain by
    pointer doubling over a row's 128 residues.

    The low 7 bits of x move on their own, so S_k[s], the wrapped sum of
    the 2^k values added from residue s, gives 2^k steps at once: S_0 is the
    row, S_{k+1}[s] = S_k[s] + S_k[(s + S_k[s]) & 127], and for each set bit
    k of `steps` every chain takes x += S_k[x & 127]. lane_rounds(steps)
    rounds."""
    s = tbl.long()
    res = torch.arange(128, device=tbl.device)
    x = idx.long()
    k = int(steps)
    while k:
        if k & 1:
            x = _wrap32(x + s.gather(1, x & 127))
        k >>= 1
        if k:
            s = _wrap32(s + s.gather(1, (res + s) & 127))
    return x.to(torch.int32)


def row_gather_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of route row: tbl (rows, width), idx (rows, width) int32
    in [0, width)."""
    return torch.take_along_dim(tbl, idx.long(), dim=1)


def row_route(width: int) -> str:
    """Where route row gathers a row of `width` words: "registers" (a warp
    a row, 4 words a lane) or "device memory" (a thread an element)."""
    return "registers" if width <= ROW_LANE_MAX else "device memory"


def row_gather_lanes_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Route row's register form in torch, rows of up to ROW_LANE_MAX
    words: each row padded to 128 words and held as 4 registers of 32
    lanes (entry e in register e >> 5 of lane e & 31), an index x read as
    lane_take does, register (x >> 5) & 3 of lane x & 31. Raises on an
    index outside its row, where the kernel traps."""
    rows, width = tbl.shape
    if width > ROW_LANE_MAX:
        raise ValueError(f"the register form holds rows of up to {ROW_LANE_MAX} words, not {width}")
    x = idx.long()
    if bool(((x < 0) | (x >= width)).any()):
        raise IndexError("an index lies outside its row")
    regs = torch.zeros((rows, 4, 32), dtype=tbl.dtype, device=tbl.device)
    regs.view(rows, 128)[:, :width] = tbl
    r = torch.arange(rows, device=tbl.device)[:, None]
    return regs[r, (x >> 5) & 3, x & 31]


def gather_taa_warps_plain(table: torch.Tensor, idx0: torch.Tensor, steps: int) -> torch.Tensor:
    """Route taa's kernel in torch: gather_steps_plain's function on table
    (rows, ts), a warp a row. Lane l of a row's warp copies the row's
    16-byte quads l, l + 32, ... into the warp's part of shared memory;
    lanes 0-3 then walk the row's four chains there. Raises where a first
    index lies outside its table, where the kernel traps."""
    rows, ts = table.shape
    x = idx0.long()
    if bool(((x < 0) | (x >= ts)).any()):
        raise IndexError("a first index lies outside its table")
    quads = table.view(rows, ts // 4, 4)
    smem = torch.empty_like(quads)
    for lane in range(min(32, ts // 4)):
        smem[:, lane::32] = quads[:, lane::32]
    smem = smem.view(rows, ts)
    for _ in range(steps):
        x = (x + smem.gather(1, x).long()) & (ts - 1)
    return x.to(torch.int32)


def _check(route: str, *tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{route} takes contiguous int32 tensors on {dev}")


def take_route(ts: int, device) -> tuple:
    """(rows a block, route) of route take at table width ts on the card:
    the rows staged in shared memory, or 0 and the read-only-path walk."""
    rpb = kernels.micro_gather_take_rows(ts, device)
    return rpb, "shared memory" if rpb else "read-only path"


def gather_take(table_flat: torch.Tensor, idx0: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """Route take: as gather_steps_plain, the table (rows * ts,) staged a
    block's rows at a time in shared memory (16-byte aligned), or walked
    through the read-only path where a row does not fit; on the card a
    first index outside [0, ts) traps."""
    if table_flat.device.type == "cpu":
        return gather_steps_plain(table_flat, idx0, steps)
    rows = idx0.shape[0]
    if table_flat.dim() != 1 or idx0.dim() != 2 or idx0.shape[1] != 4 or table_flat.numel() % max(rows, 1):
        raise ValueError("gather_take takes table (rows * ts,) and idx0 (rows, 4)")
    _check("gather_take", table_flat, idx0)
    if table_flat.data_ptr() % 16:
        raise ValueError("gather_take's table must start on a 16-byte boundary")
    out = torch.empty_like(idx0)
    kernels.launch_micro_gather("gather_take", table_flat, idx0, out, rows, table_flat.numel() // max(rows, 1), steps)
    return out


def gather_taa(table2d: torch.Tensor, idx0: torch.Tensor, steps: int = STEPS) -> torch.Tensor:
    """Route taa: as gather_steps_plain, the table (rows, ts) staged in
    shared memory a warp a row (`gather_taa_warps_plain`); on
    the card a first index outside [0, ts) traps, and rows larger than a
    block's shared memory are refused."""
    if table2d.device.type == "cpu":
        return gather_steps_plain(table2d, idx0, steps)
    if table2d.dim() != 2 or idx0.shape != (table2d.shape[0], 4):
        raise ValueError("gather_taa takes table (rows, ts) and idx0 (rows, 4)")
    _check("gather_taa", table2d, idx0)
    if table2d.data_ptr() % 16:
        raise ValueError("gather_taa's table must start on a 16-byte boundary")
    out = torch.empty_like(idx0)
    kernels.launch_micro_gather("gather_taa", table2d, idx0, out, table2d.shape[0], table2d.shape[1], steps)
    return out


def lane_steps(tbl: torch.Tensor, idx: torch.Tensor, steps: int = LSTEPS) -> torch.Tensor:
    """Route lane: as lane_steps_plain, by the pointer doubling of
    lane_steps_doubling_plain, a warp a row with its 128 entries in
    registers."""
    if tbl.device.type == "cpu":
        return lane_steps_plain(tbl, idx, steps)
    if tbl.dim() != 2 or tbl.shape[1] != 128 or idx.shape != tbl.shape:
        raise ValueError("lane_steps takes tbl and idx of one (rows, 128) shape")
    _check("lane_steps", tbl, idx)
    out = torch.empty_like(idx)
    kernels.launch_micro_gather("gather_lane", tbl, idx, out, tbl.shape[0], 128, steps)
    return out


def row_gather(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Route row: as row_gather_plain, gathered on chip where the row fits
    (`row_route`); on the card an index outside [0, width) traps."""
    if tbl.device.type == "cpu":
        return row_gather_plain(tbl, idx)
    if tbl.dim() != 2 or idx.shape != tbl.shape:
        raise ValueError("row_gather takes tbl and idx of one (rows, width) shape")
    _check("row_gather", tbl, idx)
    out = torch.empty_like(idx)
    kernels.launch_micro_gather("gather_row", tbl, idx, out, tbl.shape[0], tbl.shape[1], 0)
    return out


def make_inputs(device) -> dict:
    """The experiment's inputs, drawn in its order from seed 0."""
    rng = np.random.default_rng(0)
    table_flat = rng.integers(0, 2**20, T * TS, dtype=np.int32)
    idx0 = rng.integers(0, TS, (T, 4), dtype=np.int32)
    table_shared = rng.integers(0, 2**14, TS, dtype=np.int32)
    tbl_small = rng.integers(0, 128, (8, 128), dtype=np.int32)
    idx_l = rng.integers(0, 128, (8, 128), dtype=np.int32)
    arrays = dict(table_flat=table_flat, idx0=idx0, table_shared=table_shared, tbl_small=tbl_small, idx_l=idx_l)
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def xla_variants(inp: dict, steps: int = STEPS) -> dict:
    """The experiment's variants 1-3 as plain PyTorch loops: {name: fn}."""
    table_flat, idx0 = inp["table_flat"], inp["idx0"]
    rows = idx0.shape[0]
    ts = table_flat.numel() // rows
    table2d = table_flat.view(rows, ts)
    base_off = torch.arange(rows, device=idx0.device)[:, None] * ts
    shared = inp["table_shared"].to(torch.bfloat16)[:, None]
    cols = torch.arange(ts, device=idx0.device)

    def flat_gather():
        idx, total = idx0.long(), 0
        for _ in range(steps):
            v = table_flat[idx + base_off].long()
            idx, total = (idx + v) & (ts - 1), total + v.sum()
        return total

    def take_along():
        idx, total = idx0.long(), 0
        for _ in range(steps):
            v = torch.take_along_dim(table2d, idx, dim=1).long()
            idx, total = (idx + v) & (ts - 1), total + v.sum()
        return total

    def one_hot():
        idx, total = idx0.long(), 0
        for _ in range(steps):
            oh = (idx.reshape(-1, 1) == cols).to(torch.bfloat16)
            v = (oh @ shared).float().view(rows, 4).long()
            idx, total = (idx + v) & (ts - 1), total + v.sum()
        return total

    return {"1. flat gather in a loop": flat_gather, "2. take_along_dim in a loop": take_along,
            "3. one-hot bf16 matmul in a loop": one_hot}


def measure_steps(route: str, inp: dict) -> dict:
    """Route take or taa at the experiment's shape against its plain
    version; also one row (4 chains) alone."""
    n0 = kernels.LAUNCHES[route]
    table_flat, idx0 = inp["table_flat"], inp["idx0"]
    rows, ts = idx0.shape[0], table_flat.numel() // idx0.shape[0]
    table = table_flat if route == "gather_take" else table_flat.view(rows, ts)
    fn = gather_take if route == "gather_take" else gather_taa
    out = fn(table, idx0, STEPS)
    common.check_equal(out, gather_steps_plain(table, idx0, STEPS), route)
    t = common.kernel_ms(lambda: fn(table, idx0, STEPS))
    one_table = table[:ts] if route == "gather_take" else table[:1]
    one_idx = idx0[:1].contiguous()
    one = common.time_ms(lambda: fn(one_table, one_idx, STEPS), hold=True)
    plain = common.time_plain_ms(lambda: gather_steps_plain(table, idx0, STEPS))
    lookups = rows * 4 * STEPS
    extra, units = {}, ""
    if route == "gather_take":
        rpb, how = take_route(ts, table.device)
        extra, units = dict(rows_per_block=rpb, take_route=how), f"; {how}, {rpb} rows a block"
    return common.row(route, f"T={rows} TS={ts} STEPS={STEPS}", kernels.LAUNCHES[route] - n0, t, plain[0],
                      None, common.bound(common.nbytes(table_flat, idx0, out), lookups * OPS_PER_LOOKUP),
                      f"{lookups / t[1] / 1e3:.1f} M lookups/s (card alone); one row (4 chains) alone {one[0]:.4f} ms "
                      f"(card alone){units}", one_row_ms=one[0], **extra)


def measure_lane(inp: dict) -> dict:
    """Route lane at the experiment's shape against its plain version. The
    bound counts the doubling's operations, OPS_PER_LOOKUP a lookup: a
    lane's chains at each set bit of LSTEPS and its S entries at each later
    round (`doubling_ops`). `step_loop_bound_ms` counts the step loop's
    instead, the bound of the route's first design."""
    n0 = kernels.LAUNCHES["gather_lane"]
    tbl, idx = inp["tbl_small"], inp["idx_l"]
    out = lane_steps(tbl, idx, LSTEPS)
    common.check_equal(out, lane_steps_plain(tbl, idx, LSTEPS), "gather_lane")
    t = common.kernel_ms(lambda: lane_steps(tbl, idx, LSTEPS))
    one_t, one_i = tbl[:1].contiguous(), idx[:1].contiguous()
    one = common.time_ms(lambda: lane_steps(one_t, one_i, LSTEPS), hold=True)
    plain = common.time_plain_ms(lambda: lane_steps_plain(tbl, idx, LSTEPS))
    chain_steps = idx.numel() * LSTEPS
    rounds = lane_rounds(LSTEPS)
    doubling = idx.numel() * (bin(LSTEPS).count("1") + rounds - 1)
    n_bytes = common.nbytes(tbl, idx, out)
    return common.row("gather_lane", f"(8, 128) LSTEPS={LSTEPS}", kernels.LAUNCHES["gather_lane"] - n0, t,
                      plain[0], None, common.bound(n_bytes, doubling * OPS_PER_LOOKUP),
                      f"{chain_steps / t[1] / 1e6:.1f} G chain-steps/s (card alone), {rounds} rounds of pointer "
                      f"doubling ({doubling * OPS_PER_LOOKUP:,} operations, the step loop's "
                      f"{chain_steps * OPS_PER_LOOKUP:,}); one row (one warp) alone {one[0]:.4f} ms",
                      one_row_ms=one[0], rounds=rounds, doubling_ops=doubling * OPS_PER_LOOKUP,
                      step_loop_bound_ms=common.bound(n_bytes, chain_steps * OPS_PER_LOOKUP)[0])


def main(device="cuda") -> list:
    """The experiment's shapes on the card, printed; returns the routes'
    rows."""
    dev = common.cuda_device(device)
    card = common.card_line()
    inp = make_inputs(dev)
    print(f"E3 lanes={T}, steps={STEPS}, lookups per run = {T * STEPS * 4:,} [{card}]", flush=True)
    for name, fn in xla_variants(inp).items():
        t = common.time_plain_ms(fn)
        print(f"E3 {name} (plain PyTorch yardstick): {t[0]:.4f} ms, "
              f"{T * STEPS * 4 / t[0] / 1e3:.1f} M lookups/s [{card}]", flush=True)
    rows = [common.report("E3", measure_steps(route, inp), card) for route in ("gather_take", "gather_taa")]
    return rows + [common.report("E3", measure_lane(inp), card)]


if __name__ == "__main__":
    main()
