"""E2 on a GPU: the on-chip bitonic row sort of the JAX repository's
`experiments/pallas_bitonic.py`, with the plain network of its
`experiments/bitonic_jnp.py`.

Each row of u32 keys (int32 tensors holding the bits) in ascending unsigned
order: the function of K8 row_sort (csrc/row_sort.cu), by another design.
The TPU prototype keeps an (8, m) row block in VMEM through all
p(p + 1) / 2 stages of the network; the kernel here (csrc/bitonic_cluster.cu)
keeps each row in the shared memory of one thread-block cluster, up to 8
blocks of 2^15 keys, so rows of up to 2^18 keys are read and written once.
Longer rows are refused (ValueError); K8 sorts those through device memory.

    python -m pcodec_tpu_torch.experiments.pallas_bitonic

runs the experiment's checks ((8, 256) and (16, 1,024)) and its first bench
shape, (96, 2^16), through the kernel on the card against the plain network
bit for bit, beside K8 and torch.sort. Its second shape, (32, 2^21), is
beyond the kernel: it prints the limit and times K8 and torch.sort there.
"""

import numpy as np
import torch

from pcodec_tpu_torch.experiments import common
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops.row_sort import MIN32, row_sort_u32, row_sort_u32_plain

BLOCK_KEYS = 1 << 15  # keys a block holds in shared memory (128 KB)
MAX_CLUSTER = 8  # blocks of a portable cluster
MAX_KEYS = BLOCK_KEYS * MAX_CLUSTER
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


def cluster_blocks(m: int) -> int:
    """Blocks of the cluster that holds a row of m keys; ValueError for a
    length the kernel does not take."""
    if m < 2 or m & (m - 1):
        raise ValueError(f"sort_rows_u32 takes rows of a power-of-two length of at least 2, not {m}")
    if m > MAX_KEYS:
        raise ValueError(f"a row of {m} keys is longer than one cluster holds on chip: at most {MAX_KEYS} keys "
                         f"({MAX_CLUSTER} blocks of {BLOCK_KEYS} keys, 128 KB of shared memory each)")
    return max(1, m // BLOCK_KEYS)


def sort_rows_u32(x: torch.Tensor) -> torch.Tensor:
    """E2: as sort_rows_u32_plain, into a new tensor, for rows that one
    cluster holds (ValueError otherwise, on every device); on the card each
    row sorted on chip by one cluster."""
    if x.dim() != 2:
        raise ValueError("sort_rows_u32 takes a (rows, m) tensor")
    cluster_blocks(x.shape[1])
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
    got = sort_rows_u32(x)
    common.check_equal(got, sort_rows_u32_plain(x), f"bitonic_cluster ({rows}, {m})")
    if not np.array_equal(got.cpu().numpy().view(np.uint32), _sorted_np(x)):
        raise AssertionError(f"bitonic_cluster ({rows}, {m}) differs from numpy's sort")


def measure(rows: int, m: int, device="cuda") -> dict:
    """The kernel against the plain network, K8 and torch.sort (of the
    sign-flipped keys, flipped untimed) at (rows, m), on the card."""
    dev = common.cuda_device(device)
    n0 = kernels.LAUNCHES["bitonic_cluster"]
    x = make_keys(rows, m, 1, dev)
    got = sort_rows_u32(x)
    common.check_equal(got, sort_rows_u32_plain(x), f"bitonic_cluster ({rows}, {m})")
    if not np.array_equal(got.cpu().numpy().view(np.uint32), _sorted_np(x)):
        raise AssertionError(f"bitonic_cluster ({rows}, {m}) differs from numpy's sort")
    common.check_equal(row_sort_u32(x), got, f"K8 row_sort ({rows}, {m})")
    xf = x ^ MIN32
    t = common.kernel_ms(lambda: sort_rows_u32(x))
    k8 = common.kernel_ms(lambda: row_sort_u32(x))
    plain = common.time_plain_ms(lambda: sort_rows_u32_plain(x))
    lib = common.time_ms(lambda: torch.sort(xf, dim=1))
    return common.row("bitonic_cluster", f"({rows}, {m})", kernels.LAUNCHES["bitonic_cluster"] - n0, t, plain[0],
                      lib[0], common.bound(2 * x.numel() * 4, int(rows * m * np.log2(m))),
                      f"{rows * m / t[1] / 1e3:.1f} M keys/s (card alone); K8 row_sort {k8[0][0]:.4f} ms a call, "
                      f"card alone {k8[1]:.4f} ms; cluster of {cluster_blocks(m)} blocks", k8_ms=k8[0][0])


def beyond_cluster(rows: int, m: int, device="cuda") -> str:
    """A shape the kernel refuses: the limit it names, then K8 and
    torch.sort timed there."""
    dev = common.cuda_device(device)
    x = make_keys(rows, m, 1, dev)
    try:
        sort_rows_u32(x)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError(f"bitonic_cluster took a row of {m} keys")
    common.check_equal(row_sort_u32(x), row_sort_u32_plain(x), f"K8 row_sort ({rows}, {m})")
    xf = x ^ MIN32
    k8 = common.time_ms(lambda: row_sort_u32(x))
    lib = common.time_ms(lambda: torch.sort(xf, dim=1))
    return (f"bitonic_cluster ({rows}, {m}): refused: {refused}. Instead, at this shape: K8 row_sort "
            f"{k8[0]:.4f} ms (min {k8[1]:.4f}, max {k8[2]:.4f}), torch.sort {lib[0]:.4f} ms")


def main(device="cuda") -> list:
    """The experiment's checks and shapes on the card, printed; returns the
    kernel's row."""
    common.cuda_device(device)
    card = common.card_line()
    for rows, m in CHECKS:
        check(rows, m, device)
        print(f"E2 check rows={rows} m={m}: OK (== plain network == numpy sort) [{card}]", flush=True)
    (rows, m), (rows2, m2) = BENCH
    row = common.report("E2", measure(rows, m, device), card)
    print(f"E2 {beyond_cluster(rows2, m2, device)} [{card}]", flush=True)
    return [row]


if __name__ == "__main__":
    main()
