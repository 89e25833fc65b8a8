"""Quantile histogram with exact counts and tight bounds.

The reference computes this with a partial quicksort
(ref: pco/src/histograms.rs:208-298); the result is a deterministic function
of the multiset of latents, equal to running its `apply_sorted` walk over
fully sorted data. We sort with numpy (O(n log n), vectorized) and run the
walk at run granularity — O(n_bins) python iterations, each O(log n).
"""

from dataclasses import dataclass

import numpy as np


@dataclass
class HistogramBin:
    count: int
    lower: int  # python int (unsigned latent value)
    upper: int


class _Builder:
    def __init__(self, n: int, n_bins_log: int):
        self.n = n
        self.n_bins = 1 << n_bins_log
        self.n_bins_log = n_bins_log
        self.n_applied = 0
        self.next_avail_bin_idx = 0
        self.incomplete = None  # (count, lower, upper)
        self.dst = []

    def bin_idx(self, c_count: int) -> int:
        return (c_count << self.n_bins_log) // self.n

    def c_count(self, bin_idx: int) -> int:
        return ((bin_idx + 1) * self.n + self.n_bins - 1) >> self.n_bins_log

    def apply_incomplete(self, count: int, lower: int, upper: int) -> None:
        if count == 0:
            return
        if self.incomplete is not None:
            c, lo, _ = self.incomplete
            self.incomplete = (c + count, lo, upper)
        else:
            self.incomplete = (count, lower, upper)
        self.n_applied += count

    def complete_bin(self, bin_idx: int) -> bool:
        if self.incomplete is None:
            return False
        self.next_avail_bin_idx = bin_idx + 1
        c, lo, up = self.incomplete
        self.dst.append(HistogramBin(c, lo, up))
        self.incomplete = None
        return True

    def apply_constant_run(self, count: int, value: int) -> None:
        # ref: histograms.rs:142-161
        start = self.n_applied
        mid = start + count // 2
        end = start + count
        bin_idx = self.bin_idx(mid)
        if bin_idx > self.next_avail_bin_idx:
            spare = bin_idx - 1
            if not self.complete_bin(spare):
                bin_idx = spare
        self.apply_incomplete(count, value, value)
        if end >= self.c_count(bin_idx):
            self.complete_bin(bin_idx)


def histogram(latents: np.ndarray, n_bins_log: int, sort_in_place: bool = False, sort=None):
    """Returns list[HistogramBin] identical to the reference's histogram().

    sort_in_place=True lets a caller that owns `latents` skip np.sort's
    internal copy (a full-array pass). `sort`, when given, returns its
    argument's values in ascending order in place of np.sort (the GPU
    encoder sorts on the card)."""
    n = len(latents)
    if n == 0:
        return []
    if sort is not None:
        s = sort(latents)
    elif sort_in_place:
        latents.sort()
        s = latents
    else:
        s = np.sort(latents)
    try:
        from pcodec_tpu_torch.native import kernels as _native
    except Exception:  # pragma: no cover
        _native = None
    if _native is not None:
        su = s if s.dtype == np.uint64 else s.astype(np.uint64)
        counts, lowers, uppers = _native.histogram_sorted(su, n_bins_log)
        return [
            HistogramBin(int(cc), int(lo), int(up))
            for cc, lo, up in zip(counts.tolist(), lowers.tolist(), uppers.tolist())
        ]
    b = _Builder(n, n_bins_log)
    pos = 0
    while pos < n:
        target_bin_idx = b.bin_idx(b.n_applied)
        target_c_count = b.c_count(target_bin_idx)
        target_i = target_c_count - b.n_applied

        if target_i >= n - pos:
            b.apply_incomplete(n - pos, int(s[pos]), int(s[n - 1]))
            if target_i == n - pos:
                b.complete_bin(target_bin_idx)
            break

        target_x = s[pos + target_i - 1]
        l = int(np.searchsorted(s, target_x, side="left"))
        r = int(np.searchsorted(s, target_x, side="right"))
        l = max(l, pos)

        if l > pos:
            b.apply_incomplete(l - pos, int(s[pos]), int(s[l - 1]))
        b.apply_constant_run(r - l, int(target_x))
        pos = r
    return b.dst
