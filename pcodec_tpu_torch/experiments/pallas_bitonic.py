"""E2 on a GPU: the on-chip bitonic row sort of the JAX repository's
`experiments/pallas_bitonic.py`, with the plain network of its
`experiments/bitonic_jnp.py`.

Each row of u32 keys (int32 tensors holding the bits) in ascending unsigned
order: the function of K8 row_sort (csrc/row_sort.cu), by another design.
The TPU prototype keeps an (8, m) row block in VMEM through all
p(p + 1) / 2 stages of the network. The kernel here (csrc/bitonic_cluster.cu)
does the network's stages in registers, 32 keys a thread, 5 index bits of
stages a pass through shared memory; a tile of up to 2^17 keys is held by
one thread-block cluster. Rows longer than a tile are sorted in tiles of
2^17, then merged: the stages at bits above the tile through device memory,
those below it on chip (`sort_plan`). Every power-of-two row length from 2
to 2^31 is taken.

    python -m pcodec_tpu_torch.experiments.pallas_bitonic

runs the experiment's checks ((8, 256) and (16, 1,024)) and its two bench
shapes, (96, 2^16) and (32, 2^21), through the kernel on the card against
the plain network and numpy's sort bit for bit, beside K8 and torch.sort.
"""

import numpy as np
import torch

from pcodec_tpu_torch.experiments import common
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops.row_sort import MIN32, row_sort_u32, row_sort_u32_plain

SET_KEYS = 32  # keys a thread holds in registers: 5 index bits of stages a pass
BLOCK_KEYS = 1 << 14  # most keys a block holds in shared memory
MAX_CLUSTER = 8  # blocks of a portable cluster
TILE_KEYS = BLOCK_KEYS * MAX_CLUSTER  # longest run one cluster sorts on chip
MAX_KEYS = 1 << 31  # longest row
CHECKS = ((8, 256), (16, 1024))
BENCH = ((96, 1 << 16), (32, 1 << 21))


def bitonic_sort(x: torch.Tensor) -> torch.Tensor:
    """Ascending bitonic sort along the last axis of (rows, m), m a power of
    two, in the signed order of x's type: the network of bitonic_jnp.py.

    For each run length k = 2, 4, .., m, a flip stage compares element j
    with element k - 1 - j of each k-block (turning two sorted k/2-runs into
    a bitonic k-run), then cleanup stages compare at distances k/4 .. 1."""
    rows, m = x.shape
    if m & (m - 1):
        raise ValueError(f"bitonic_sort takes rows of a power-of-two length, not {m}")
    k = 2
    while k <= m:
        y = x.reshape(rows, m // k, k)
        a, b = y[:, :, : k // 2], y[:, :, k // 2:].flip(2)
        x = torch.cat([torch.minimum(a, b), torch.maximum(a, b).flip(2)], dim=2).reshape(rows, m)
        j = k // 4
        while j >= 1:
            y = x.reshape(rows, m // (2 * j), 2, j)
            a, b = y[:, :, 0], y[:, :, 1]
            x = torch.stack([torch.minimum(a, b), torch.maximum(a, b)], dim=2).reshape(rows, m)
            j //= 2
        k *= 2
    return x


def sort_rows_u32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of E2: x (rows, m) int32 holding u32 keys, sorted by the
    network with the sign bit flipped, as the experiment does."""
    return bitonic_sort(x ^ MIN32) ^ MIN32


def sort_plan(m: int, tile_keys: int = TILE_KEYS) -> dict:
    """E2's launches for rows of m keys, as csrc/bitonic_cluster.cu plans
    them at its tile of TILE_KEYS; a smaller tile_keys plans the same
    schedule for the CPU twin's tests. ValueError for a length or tile the
    kernel does not take.

    Rows under 32 keys are sorted a thread a row ("rows"). Longer rows are
    cut into tiles of T = min(m, tile_keys) keys, each held by a cluster of
    `blocks` blocks of `block_keys` keys: ("tile", 5, log2 T) sorts each
    tile on chip; then for each run length 2^q past the tile, ("global", q,
    a, r) does the network's stages at index bits a + r - 1 .. a (at least
    log2 T) through device memory, 2^r keys a set in registers, and
    ("tile", q, q) its stages below log2 T on chip."""
    if m < 2 or m & (m - 1) or m > MAX_KEYS:
        raise ValueError(f"sort_rows_u32 takes rows of a power-of-two length from 2 to {MAX_KEYS}, not {m}")
    if tile_keys < SET_KEYS or tile_keys & (tile_keys - 1) or tile_keys > TILE_KEYS:
        raise ValueError(f"a tile is a power of two from {SET_KEYS} to {TILE_KEYS} keys, not {tile_keys}")
    if m < SET_KEYS:
        return dict(tile_keys=m, blocks=1, block_keys=m, launches=[("rows",)])
    tile = min(m, tile_keys)
    lt, L = tile.bit_length() - 1, m.bit_length() - 1
    block = min(tile, BLOCK_KEYS)
    launches = [("tile", 5, lt)]
    for q in range(lt + 1, L + 1):
        hi = q
        while hi > lt:
            r = min(5, hi - lt)
            launches.append(("global", q, hi - r, r))
            hi -= r
        launches.append(("tile", q, q))
    return dict(tile_keys=tile, blocks=tile // block, block_keys=block, launches=launches)


def tile_groups(q: int, lt: int) -> list:
    """The on-chip passes of the merge of run length 2^q in a tile of 2^lt
    keys: (a, g), a set being the 32 keys that differ in index bits a .. a + 4,
    the pass doing the stages at bits a + g - 1 .. a; from the top."""
    out, hi = [], min(q, lt)
    while hi > 0:
        a = max(hi - 5, 0)
        out.append((a, hi - a))
        hi = a
    return out


_U32 = 0xFFFFFFFF


def _stage(u: torch.Tensor, b: int) -> torch.Tensor:
    """One ascending stage of the network on u (rows, n): key i against key
    i + 2^b, for each i with bit b clear, the smaller first."""
    rows, n = u.shape
    y = u.reshape(rows, n >> (b + 1), 2, 1 << b)
    lo, hi = y[:, :, 0], y[:, :, 1]
    return torch.stack([torch.minimum(lo, hi), torch.maximum(lo, hi)], dim=2).reshape(rows, n)


def _sort32(u: torch.Tensor) -> torch.Tensor:
    """Each run of 32 keys of u ascending, by the network a thread runs in
    its registers: for k = 2 .. 32, j = k / 2 .. 1, key e against e ^ j,
    descending where e & k."""
    rows, n = u.shape
    v = u.reshape(-1, SET_KEYS)
    e = torch.arange(SET_KEYS // 2, device=u.device)
    k = 2
    while k <= SET_KEYS:
        j = k // 2
        while j >= 1:
            lo_e = ((e & ~(j - 1)) << 1) | (e & (j - 1))  # the keys with bit j clear
            x, y = v[:, lo_e], v[:, lo_e + j]
            mn, mx = torch.minimum(x, y), torch.maximum(x, y)
            desc = (lo_e & k) != 0
            v = v.clone()
            v[:, lo_e], v[:, lo_e + j] = torch.where(desc, mx, mn), torch.where(desc, mn, mx)
            j //= 2
        k *= 2
    return v.reshape(rows, n)


def _as_i32(u: torch.Tensor) -> torch.Tensor:
    return (((u + (1 << 31)) & _U32) - (1 << 31)).to(torch.int32)


def sort_rows_u32_tiled_plain(x: torch.Tensor, tile_keys: int = TILE_KEYS) -> torch.Tensor:
    """E2's kernel in torch, launch for launch and pass for pass (sort_plan,
    tile_groups), for the CPU tests: the function of sort_rows_u32_plain.

    The kernel runs the network's stages all ascending: after the merge of
    run length 2^q, a run that the network leaves descending (bit q of its
    index set) is held complemented, which reverses the u32 order. So a
    merge's first pass complements the keys whose bits q - 1 and q differ,
    and every compare-exchange puts the smaller key first."""
    rows, m = x.shape
    plan = sort_plan(m, tile_keys)
    u = x.long() & _U32
    if m < SET_KEYS:
        pad = torch.full((rows, SET_KEYS - m), _U32, dtype=torch.long, device=x.device)
        return _as_i32(_sort32(torch.cat([u, pad], dim=1))[:, :m])
    i = torch.arange(m, device=x.device)
    lt = plan["tile_keys"].bit_length() - 1

    def flip(u, q):  # into the merge of 2^q from the runs of 2^(q - 1)
        return torch.where(((i >> (q - 1)) ^ (i >> q)) & 1 == 1, u ^ _U32, u)

    for launch in plan["launches"]:
        if launch[0] == "global":
            _, q, a, r = launch
            if a + r == q:
                u = flip(u, q)
            for b in range(a + r - 1, a - 1, -1):
                u = _stage(u, b)
            continue
        _, q0, q1 = launch
        for q in range(q0, q1 + 1):
            if q == 5:
                u = _sort32(torch.where((i >> 5) & 1 == 1, u ^ _U32, u))
                continue
            if q <= lt:
                u = flip(u, q)
            for a, g in tile_groups(q, lt):
                for b in range(a + g - 1, a - 1, -1):
                    u = _stage(u, b)
    return _as_i32(u)


def sort_rows_u32(x: torch.Tensor) -> torch.Tensor:
    """E2: as sort_rows_u32_plain, into a new tensor, for rows of any
    power-of-two length (ValueError otherwise, on every device); on the card
    by the launches sort_plan(m) names."""
    if x.dim() != 2:
        raise ValueError("sort_rows_u32 takes a (rows, m) tensor")
    sort_plan(x.shape[1])
    if x.device.type == "cpu":
        return sort_rows_u32_plain(x)
    if x.dtype != torch.int32 or not x.is_contiguous():
        raise ValueError("sort_rows_u32 takes a contiguous int32 tensor")
    out = x.clone()
    kernels.launch_bitonic_cluster(out)
    return out


def make_keys(rows: int, m: int, seed: int, device) -> torch.Tensor:
    """Uniform u32 keys as int32, drawn as the experiment draws them."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 32, (rows, m), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def _sorted_np(x: torch.Tensor) -> np.ndarray:
    return np.sort(x.cpu().numpy().view(np.uint32), axis=1)


def check(rows: int, m: int, device="cuda") -> None:
    """The experiment's check on the card: the kernel equals the plain
    network and numpy's sort."""
    x = make_keys(rows, m, 0, common.cuda_device(device))
    _check_sorted(sort_rows_u32(x), x)


def _check_sorted(got: torch.Tensor, x: torch.Tensor) -> None:
    what = f"bitonic_cluster {tuple(x.shape)}"
    common.check_equal(got, sort_rows_u32_plain(x), what)
    if not np.array_equal(got.cpu().numpy().view(np.uint32), _sorted_np(x)):
        raise AssertionError(f"{what} differs from numpy's sort")


def measure(rows: int, m: int, device="cuda") -> dict:
    """The kernel against the plain network, numpy's sort, K8 and
    torch.sort (of the sign-flipped keys, flipped untimed) at (rows, m), on
    the card."""
    dev = common.cuda_device(device)
    n0 = kernels.LAUNCHES["bitonic_cluster"]
    x = make_keys(rows, m, 1, dev)
    got = sort_rows_u32(x)
    _check_sorted(got, x)
    common.check_equal(row_sort_u32(x), got, f"K8 row_sort ({rows}, {m})")
    xf = x ^ MIN32
    t = common.kernel_ms(lambda: sort_rows_u32(x))
    k8 = common.kernel_ms(lambda: row_sort_u32(x))
    plain = common.time_plain_ms(lambda: sort_rows_u32_plain(x))
    lib = common.kernel_ms(lambda: torch.sort(xf, dim=1))
    plan = sort_plan(m)
    kinds = [launch[0] for launch in plan["launches"]]
    return common.row("bitonic_cluster", f"({rows}, {m})", kernels.LAUNCHES["bitonic_cluster"] - n0, t, plain[0],
                      lib[0][0], common.bound(2 * x.numel() * 4, int(rows * m * np.log2(m))),
                      f"{rows * m / t[1] / 1e3:.1f} M keys/s (card alone); K8 row_sort {k8[0][0]:.4f} ms a call, "
                      f"card alone {k8[1]:.4f} ms; torch.sort card alone {lib[1]:.4f} ms; tiles of "
                      f"{plan['tile_keys']} keys, clusters of {plan['blocks']} blocks; {kinds.count('tile')} tile "
                      f"and {kinds.count('global')} device-memory kernels a call",
                      k8_ms=k8[0][0], k8_device_ms=k8[1], library_device_ms=lib[1])


def main(device="cuda") -> list:
    """The experiment's checks and shapes on the card, printed; returns the
    kernel's row at its first bench shape, with its numbers at the second
    (`long_rows`)."""
    common.cuda_device(device)
    card = common.card_line()
    for rows, m in CHECKS:
        check(rows, m, device)
        print(f"E2 check rows={rows} m={m}: OK (== plain network == numpy sort) [{card}]", flush=True)
    row, long_row = (common.report("E2", measure(rows, m, device), card) for rows, m in BENCH)
    row["long_rows"] = {k: long_row[k] for k in ("shape", "launches", "ms", "device_ms", "plain_ms", "library_ms",
                                                 "library_device_ms", "k8_ms", "k8_device_ms", "bound_ms", "bound_by")}
    return [row]


if __name__ == "__main__":
    main()
