"""Measurement helpers of the port, shared by the microbenchmarks of this
package and by chip_smoke.py: the card they run on, CUDA-event timing, the
device time of each kernel in a profiler's trace, the bound of a function,
the bit-for-bit check of a kernel against its plain version and the result
row of one kernel at one shape.

Every number here comes from the card: `cuda_device` raises when there is
none, and no measurement falls back to the CPU.
"""

import re
import statistics
import subprocess

import torch

RUNS = 10  # timed runs a kernel, after WARMUP untimed ones (plain versions: 3 after 1)
WARMUP = 2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit rate
HOLD_CYCLES = 2_000_000  # about 1 ms of spin, far longer than the host takes to enqueue one call


def cuda_device(device="cuda") -> torch.device:
    """`device` as a CUDA device; raises for another device or without a card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the microbenchmarks time their kernels on a CUDA device, not on {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    return dev


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, runs=RUNS, warmup=WARMUP, hold=False):
    """Median, min and max of `runs` CUDA-event timings of fn() in ms: one
    call between two events, so a call shorter than its host-side launch
    cost reads that cost. With hold, the card first spins (torch.cuda._sleep)
    while the host enqueues the events and fn's launches: the time is then
    the card's alone (for an fn that does not wait on the card)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), min(times), max(times)


def time_plain_ms(fn):
    return time_ms(fn, runs=3, warmup=1)


def traced_kernels(fn, calls=1) -> dict:
    """{kernel name: (device ms, launches)} summed over the launches of
    `calls` calls of fn that torch.profiler's trace holds, after a first
    step of one call that the profiler traces and drops (its warm-up). A
    trace may still hold none of fn's kernels: in chip_smoke.py, after the
    process's earlier traces, the first trace at each of E1's shapes held
    neither of its kernels and the second held both. A caller that needs
    named kernels traces again (`kernel_split_ms`)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA], schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for step in range(2):
            for _ in range(calls if step else 1):
                fn()
            torch.cuda.synchronize()
            prof.step()
    got = {}
    for e in prof.key_averages():
        if getattr(e, "device_time_total", 0) > 0:
            name = re.split(r"[<(]", e.key.replace("(anonymous namespace)::", "").replace("void ", ""))[0].strip()
            ms, n = got.get(name, (0.0, 0))
            got[name] = (ms + e.device_time_total / 1e3, n + e.count)
    return got


def kernel_split_ms(fn, prefixes, calls=5, tries=3) -> dict:
    """{prefix: device ms a launch} of fn's kernels whose names start with
    each prefix: the mean of those launches in torch.profiler's trace of
    `calls` calls, the trace taken again (up to `tries` traces) while it
    holds none for a prefix; None for a prefix no trace held. Also "held",
    the names of the last trace's kernels, and "tries", the traces taken."""
    for k in range(1, tries + 1):
        traced = traced_kernels(fn, calls)
        if all(any(name.startswith(p) for name in traced) for p in prefixes):
            break
    got = {}
    for p in prefixes:
        ms, n = (sum(v[i] for name, v in traced.items() if name.startswith(p)) for i in (0, 1))
        got[p] = ms / n if n else None
    return got | {"held": sorted(traced), "tries": k}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: int, n_ops: int = 0):
    """(ms, "bytes" or "operations"): the least time the card could take to
    move n_bytes and do n_ops 32-bit integer operations."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / SCALAR_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def check_equal(got: torch.Tensor, want: torch.Tensor, what: str = "a kernel") -> float:
    """0.0 (the max_abs_err of a kernel row) when the kernel's output equals
    the plain version's bit for bit; raises otherwise."""
    if got.shape != want.shape or not torch.equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else got.numel()
        raise AssertionError(f"{what} differs from its plain version at {bad} of {want.numel()} values")
    return 0.0


def kernel_ms(fn):
    """(a call's times, the card's median alone) of a kernel wrapper."""
    return time_ms(fn), time_ms(fn, hold=True)[0]


def row(name, shape, launches, ms, plain_ms, library_ms, bound_ms_by, units, **extra) -> dict:
    """One kernel at one shape: the launches made at that shape (the check,
    warm-ups and timed runs), its times (ms as (a call's (median, min, max)
    of RUNS runs), the card's median alone), its bound and the experiment's
    own units, as `main()` prints them and chip_smoke.py reports them."""
    ms, device_ms = ms
    return dict(name=name, shape=shape, launches=launches, timed_runs=RUNS, ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1],
                max_abs_err=0.0, units=units, **extra)


def report(tag: str, r: dict, card: str) -> dict:
    """Print one row beside the card's name and power limit; return it."""
    lib = f", library {r['library_ms']:.4f} ms" if r["library_ms"] is not None else ""
    print(f"{tag} {r['name']} {r['shape']}: {r['ms'][0]:.4f} ms a call (min {r['ms'][1]:.4f}, max {r['ms'][2]:.4f}), "
          f"card alone {r['device_ms']:.4f} ms, {r['units']}; plain {r['plain_ms']:.4f} ms{lib}, "
          f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}); {r['launches']} launches [{card}]", flush=True)
    return r
