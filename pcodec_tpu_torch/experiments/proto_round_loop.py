"""E4 on a GPU: the tANS round skeleton of the JAX repository's
`experiments/proto_round_loop.py`, on fake data.

A tile holds 256 chains x 4 streams: chain (s, g) on lanes 4g..4g+3 of row
s of an (8, 128) tile, stream j on lane 4g + j. Per round, each stream j of
chain (s, g), in order (int32, wrapping, shifts logical):

    node = node_tab[s, state_j]    (node_tab[s, state_j & 127] when state_j
                                    lies outside [0, 1024))
    bits = node & 15, base = node >> 11
    cum_j = cursor + bits of the streams before j
    b = cum_j - 32 w0, with w0 = cursor >> 5; k = b >> 5
    window = (W4[min(k + 1, 3)] : W4[k]) >> (b & 31)
    state_j = (base + (window & ((1 << bits) - 1))) & 1023

then the cursor grows by the 4 streams' bits and the window W4 is refilled
with words (w0 + k) & 127, k < 4, of the chain's section row g * 8 + s at
the new w0 (words 0..3 at the start). Out: state + cursor, (n_tiles, 8, 128);
with emit also every round's states, (n_tiles, rounds, 8, 128). It probes
K2 chain_decode's round structure (csrc/chain_decode.cu) apart from its
real data.

The experiment's check A, one take_along_axis on (8, 128), is route
gather_row of micro_gather (`check_taa`).

    python -m pcodec_tpu_torch.experiments.proto_round_loop

runs check A and the experiment's benches (64, 256 and 1,024 tiles of 64
rounds; 256 and 1,024 with emit) on the card: the kernel
(csrc/proto_round_loop.cu) against its plain version bit for bit, and M
symbols/s.
"""

import numpy as np
import torch

from pcodec_tpu_torch.experiments import common
from pcodec_tpu_torch.experiments import micro_gather
from pcodec_tpu_torch.ops import kernels

N_GROUPS = 32
ROUNDS = 64
TS_LOG = 10
TS = 1 << TS_LOG
N_TILE_CHAINS = N_GROUPS * 8  # 256
BENCH = ((False, 64), (False, 256), (False, 1024), (True, 256), (True, 1024))  # (with_emit, n_tiles)
OPS_PER_SYMBOL = 16  # the function's integer operations a decoded symbol, the refill's share included
# the kernel's earlier design (four window words reloaded a round, a block a
# tile), card alone on an NVIDIA H100 80GB HBM3 at 700 W, ms by (with_emit,
# n_tiles), as PERF.md records it: printed beside a run's time, not measured
EARLIER_DEVICE_MS = {(False, 64): 0.0336, (False, 256): 0.0596, (False, 1024): 0.3328, (True, 256): 0.0911,
                     (True, 1024): 0.3876}
M32 = 0xFFFFFFFF


def round_loop_plain(sec, node, state, rounds: int = ROUNDS, with_emit: bool = False):
    """Plain version of E4b: sec (n_tiles, 256, 128), node (8, 1024), state
    (n_tiles, 8, 128), all int32 -> out, or (out, emit) with emit."""
    n, dev = state.shape[0], state.device
    lane = torch.arange(128, device=dev)
    j_in_quad, quad_base = lane & 3, lane & ~3
    sec_col = ((lane >> 2)[None, :] * 8 + torch.arange(8, device=dev)[:, None]) * 128  # (8, 128)
    secf = sec.reshape(n, -1)
    nodes = node.long()[None].expand(n, -1, -1)

    def refill(w0):  # W4[s, 4g + k] = sec[g*8 + s][(w0 + k) & 127], as u32 in int64
        idx = (sec_col + ((w0 + j_in_quad) & 127)).reshape(n, -1)
        return secf.gather(1, idx).view(n, 8, 128).long() & M32

    st = state.long()
    cursor = torch.zeros_like(st)
    w4 = refill(cursor)
    emits = []
    for _ in range(rounds):
        nd = nodes.gather(2, torch.where((st >= 0) & (st < TS), st, st & 127)) & M32
        bits, base = nd & 15, nd >> 11
        cum = cursor.clone()
        for d in (1, 2, 3):  # within-quad exclusive prefix of bits
            cum += torch.where(j_in_quad >= d, bits.roll(d, 2), 0)
        w0 = cursor >> 5
        b = cum - (w0 << 5)
        k_w, s_w = b >> 5, b & 31
        lo = w4.gather(2, quad_base + k_w)
        hi = w4.gather(2, quad_base + torch.clamp(k_w + 1, max=3))
        window = ((lo >> s_w) | torch.where(s_w == 0, 0, hi << (32 - s_w))) & M32
        st = (base + (window & ((1 << bits) - 1))) & (TS - 1)
        cursor = (cum + bits).gather(2, (lane | 3).expand_as(cum))
        w4 = refill(cursor >> 5)
        if with_emit:
            emits.append(st.to(torch.int32))
    out = (((st + cursor + (1 << 31)) & M32) - (1 << 31)).to(torch.int32)
    if with_emit:
        return out, (torch.stack(emits, 1) if emits else state.new_empty((n, 0, 8, 128)))
    return out


def round_loop(sec, node, state, rounds: int = ROUNDS, with_emit: bool = False):
    """E4b: as round_loop_plain."""
    if state.device.type == "cpu":
        return round_loop_plain(sec, node, state, rounds, with_emit)
    n = state.shape[0]
    if sec.shape != (n, N_TILE_CHAINS, 128) or node.shape != (8, TS) or state.shape != (n, 8, 128):
        raise ValueError("round_loop takes sec (n_tiles, 256, 128), node (8, 1024) and state (n_tiles, 8, 128)")
    for t in (sec, node, state):
        if t.device != state.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"round_loop takes contiguous int32 tensors on {state.device}")
    out = torch.empty_like(state)
    emit = torch.empty((n, rounds, 8, 128), dtype=torch.int32, device=state.device) if with_emit else None
    kernels.launch_proto_round_loop(sec, node, state, out, emit, rounds)
    return (out, emit) if with_emit else out


def make_inputs(n_tiles: int, device):
    """The experiment's inputs (seed 1): sections, a row-replicated node
    table and the initial states."""
    rng = np.random.default_rng(1)
    sec = rng.integers(0, 2**31, (n_tiles, N_TILE_CHAINS, 128), np.int32)
    node = np.tile(rng.integers(0, 2**20, (1, TS), np.int32), (8, 1))
    state = rng.integers(0, TS, (n_tiles, 8, 128), np.int32)
    return tuple(torch.from_numpy(a).to(device) for a in (sec, node, state))


def taa_inputs(device):
    """Check A's inputs (seed 0)."""
    rng = np.random.default_rng(0)
    tbl = rng.integers(0, 1000, (8, 128), dtype=np.int32)
    idx = rng.integers(0, 128, (8, 128), dtype=np.int32)
    return torch.from_numpy(tbl).to(device), torch.from_numpy(idx).to(device)


def check_taa(device="cuda") -> dict:
    """Check A on the card: route gather_row against its plain version and
    numpy's take_along_axis, and timed beside torch.gather (a call and
    the card alone)."""
    dev = common.cuda_device(device)
    n0 = kernels.LAUNCHES["gather_row"]
    tbl, idx = taa_inputs(dev)
    out = micro_gather.row_gather(tbl, idx)
    common.check_equal(out, micro_gather.row_gather_plain(tbl, idx), "gather_row")
    want = np.take_along_axis(tbl.cpu().numpy(), idx.cpu().numpy(), axis=1)
    if not np.array_equal(out.cpu().numpy(), want):
        raise AssertionError("gather_row differs from numpy's take_along_axis")
    t = common.kernel_ms(lambda: micro_gather.row_gather(tbl, idx))
    plain = common.time_plain_ms(lambda: micro_gather.row_gather_plain(tbl, idx))
    idx64 = idx.long()
    lib, lib_alone = common.kernel_ms(lambda: torch.gather(tbl, 1, idx64))
    return common.row("gather_row", "(8, 128)", kernels.LAUNCHES["gather_row"] - n0, t, plain[0], lib[0],
                      common.bound(common.nbytes(tbl, idx, out)),
                      f"take_along_axis semantics OK (per-row lane gather); torch.gather card alone {lib_alone:.4f} ms",
                      library_device_ms=lib_alone)


def measure(with_emit: bool, n_tiles: int, device="cuda", rounds: int = ROUNDS) -> dict:
    """The kernel against its plain version at n_tiles, on the card. Bound:
    the section words the chains' windows touch (words 0 to the last
    window's, from each chain's final cursor), the node table, the states
    and the outputs; OPS_PER_SYMBOL operations a symbol."""
    dev = common.cuda_device(device)
    n0 = kernels.LAUNCHES["proto_round_loop"]
    sec, node, state = make_inputs(n_tiles, dev)
    got = round_loop(sec, node, state, rounds, with_emit)
    want, want_emit = round_loop_plain(sec, node, state, rounds, True)
    for a, b in zip(got, (want, want_emit)) if with_emit else ((got, want),):
        common.check_equal(a, b, f"proto_round_loop ({n_tiles} tiles, emit {with_emit})")
    final = want_emit[:, -1] if rounds else state
    cursor = (want.long() - final.long())[:, :, ::4]
    touched = int(torch.clamp((cursor >> 5) + 4, max=128).sum())
    t = common.kernel_ms(lambda: round_loop(sec, node, state, rounds, with_emit))
    plain = common.time_plain_ms(lambda: round_loop_plain(sec, node, state, rounds, with_emit))
    syms = n_tiles * N_TILE_CHAINS * 4 * rounds
    prev = EARLIER_DEVICE_MS.get((with_emit, n_tiles)) if rounds == ROUNDS else None
    outs = got if with_emit else (got,)
    return common.row("proto_round_loop", f"{'emit' if with_emit else 'noemit'} x{n_tiles} tiles",
                      kernels.LAUNCHES["proto_round_loop"] - n0, t, plain[0], None,
                      common.bound(touched * 4 + common.nbytes(node, state, *outs), syms * OPS_PER_SYMBOL),
                      f"{syms / t[1] / 1e3:.0f} M symbols/s (card alone); windows touched {touched / sec.numel():.1%} "
                      f"of the section words" + (f"; PERF.md's record of the earlier design card alone {prev} ms"
                                                 if prev else ""))


def main(device="cuda") -> list:
    """Check A and the experiment's benches on the card, printed; returns
    their rows."""
    common.cuda_device(device)
    card = common.card_line()
    rows = [common.report("E4a", check_taa(device), card)]
    return rows + [common.report("E4b", measure(with_emit, n_tiles, device), card) for with_emit, n_tiles in BENCH]


if __name__ == "__main__":
    main()
