"""Standalone `.pco` decode on an NVIDIA GPU: the PyTorch/CUDA counterpart
of the JAX package's `plan_standalone` and `decode_standalone_device`
(`pcodec_tpu/ops/pallas_decode.py`) and of `decode_standalone_with_device`
(`pcodec_tpu/ops/decode.py`).

A standalone file stores no chunk sizes and no batch entry points (ref:
standalone/decompressor.rs:83-134): finding them means walking each
chunk's serial ANS streams. So the host walks every chunk once with the
native `decode_page_pre_delta(capture=True)`, which records each (batch,
var)'s absolute section cursors and tANS entry states, and cuts the chunk
(one page) into synthetic chains of 1,024 numbers: the entry points a PCT
directory would store. The plan is the port's own `ContainerPlan`, so the
decode runs the PCT path unchanged: K1 and K2 decode the chains, B3 (the
post) undoes a consecutive delta a chain at a time from per-chain moments
computed here on the host (the cascade streams at each chain's start) and
joins every chunk in one launch, K3 and B1 rebuild a
lookback or conv1 chunk over the whole chunk from its one stored state (a
flat chunk: ChunkPlan.flat) and K4 joins the Dict chunks. No chunk is
decoded on the host instead of the card, and no extent is refused.

    plan_standalone   host, numpy: the walk, the chains, their tables
    plan_standalone_runs
                      the same, a plan a run of chunks of one number type
                      (the C ABI's decode, `capi.py`)
    decode_standalone_device, decode_standalone_with_device
                      the entry points; the GPU unless the caller asks for
                      the CPU
"""

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from pcodec_tpu_torch.codec.container import _exact_split
from pcodec_tpu_torch.codec.decompress import PageDecompressor
from pcodec_tpu_torch.codec.standalone import FileDecompressor
from pcodec_tpu_torch.dtypes import number_type_from_np
from pcodec_tpu_torch.errors import InsufficientDataError
from pcodec_tpu_torch.format.bitio import BitReader
from pcodec_tpu_torch.format.metadata import ChunkMeta, DeltaEncoding, Mode
from pcodec_tpu_torch.native import kernels as nk
from pcodec_tpu_torch.ops import decode as dec
from pcodec_tpu_torch.ops.container_decode import (
    BATCH,
    ChunkPlan,
    ContainerPlan,
    VarPlan,
    _build_var_tables,
    _check_supported,
    _finish_plan,
    _fuse_kind,
    _resolve_device,
    decode_plan,
    to_numbers,
    upload_plan,
)

CHAIN_N = 1024  # numbers of a synthetic chain
_BATCHES = CHAIN_N // BATCH


def consecutive_chain_streams(latents: np.ndarray, page_moments: np.ndarray, order: int,
                              latent_bits: int) -> List[np.ndarray]:
    """The whole chunk's cascade streams [S_0, ..., S_{order-1}] (u64,
    wrapping) of the consecutive decode (the JAX `_consecutive_chain_streams`):
    S_order = latents + mid, S_j = [m_j, m_j + cumsum(S_{j+1})]. A chain
    starting at latent position p needs the moments S_j[p]; S_0 is the
    numbers in the latent domain."""
    mid = np.uint64(1 << (latent_bits - 1))
    s = latents.astype(np.uint64) + mid
    streams = []
    with np.errstate(over="ignore"):
        for j in range(order - 1, -1, -1):
            m = np.uint64(page_moments[j])
            s = np.concatenate([[m], m + np.cumsum(s, dtype=np.uint64)])
            streams.append(s)
    streams.reverse()
    return streams


def _chain_moments(de_v: DeltaEncoding, key: str, lat: np.ndarray, pd, n_chains: int, bits: int) -> np.ndarray:
    """(n_chains, state_n) u64 moments of a var's chains (a flat lookback or
    conv1 var: (1, state_n), the chunk's one stored state)."""
    if de_v.kind == DeltaEncoding.CONSECUTIVE:
        boundaries = np.arange(n_chains, dtype=np.int64) * CHAIN_N
        state = np.asarray(pd.plds.get(key).delta_state).astype(np.uint64)
        streams = consecutive_chain_streams(lat, state, de_v.order, bits)
        return np.stack([s[np.minimum(boundaries, len(s) - 1)] for s in streams], axis=1)
    if de_v.kind in (DeltaEncoding.LOOKBACK, DeltaEncoding.CONV1):  # the stored state, not a decoder's window
        return np.asarray(pd.page_meta.per_latent_var.get(key).delta_state).astype(np.uint64).reshape(1, -1)
    return np.zeros((n_chains, 0), dtype=np.uint64)


def _walk(data: bytes, max_n: Optional[int], entries: list):
    """The host's walk of a standalone file: appends a (number type,
    ChunkPlan, [(launch key, chain table)]) entry a chunk to `entries` and
    returns the header's uniform type. With `max_n` the walk stops after
    the chunk that brings the count to max_n, where the host's
    simple_decompress_into stops once its destination is full."""
    reader = BitReader(np.frombuffer(data, dtype=np.uint8))
    fd = FileDecompressor.new(reader)
    ci = n_seen = 0
    while True:
        pre = fd.chunk_preamble(reader)
        if pre is None:
            break
        nt, n = pre
        meta = ChunkMeta.read_from(reader, fd.format_version, nt.latent)
        _check_supported(ci, meta)
        pd = PageDecompressor(reader, meta, nt, n)  # reads the page meta
        specs = []
        for key in ("delta", "primary", "secondary"):
            cld = pd.clds.get(key)
            if cld is not None:
                specs.append({"key": key, "cld": cld, "pld": pd.plds.get(key),
                              "state_n": cld.delta_encoding.n_latents_per_state(), "is_delta": key == "delta"})
        outs, counts, new_bit, bcur, bst = nk.decode_page_pre_delta(reader, n, specs, capture=True)
        if new_bit < 0 or new_bit > 8 * len(data):
            raise InsufficientDataError("page body ran out of data")
        reader.bit_idx = new_bit
        reader.drain_empty_byte("expected trailing bits at end of page to be empty")

        page_ns = np.asarray(_exact_split(n, CHAIN_N), dtype=np.int64)
        n_chains = len(page_ns)
        n_batches = bcur.shape[0]
        boundaries = np.arange(n_chains, dtype=np.int64) * CHAIN_N
        first_batch = boundaries // BATCH
        var_plans: Dict[str, VarPlan] = {}
        items = []
        for v, spec in enumerate(specs):
            key = spec["key"]
            vm = meta.per_latent_var.get(key)
            de_v = meta.delta_encoding.for_latent_var(key)
            bins = vm.bins
            count_v = int(counts[v])
            lat = outs[v][:count_v]
            vp = VarPlan(
                key=key,
                trivial=bins.are_trivial() or len(bins) == 0,
                const_lower=int(bins.lowers[0]) if len(bins) else 0,
                moments=_chain_moments(de_v, key, lat, pd, n_chains, vm.latent_type.bits),
                bits=vm.latent_type.bits,
            )
            var_plans[key] = vp
            if vp.trivial:
                continue
            fuse = _fuse_kind(key, meta, nt)
            vp.launch_key = (CHAIN_N, fuse)
            node, lowers = _build_var_tables(vm)
            g = np.minimum(first_batch[:, None] + np.arange(_BATCHES)[None, :], n_batches - 1)
            curs = np.zeros((n_chains, 2 * _BATCHES), dtype=np.int64)
            curs[:, 0::2] = bcur[g, v, 0]
            curs[:, 1::2] = bcur[g, v, 1]
            # a chain's sections end before the next chain's first batch
            # (whose first var's ANS section starts it), else at the page's end
            nxt = first_batch + _BATCHES
            end_bit = np.where(nxt >= n_batches, np.int64(new_bit), bcur[np.minimum(nxt, n_batches - 1), 0, 0])
            moment0 = np.zeros(n_chains, dtype=np.uint64)
            if fuse:  # the fused chain starts from the numbers' stream at its boundary
                moment0 = vp.moments[:, 0].astype(np.uint64)
            items.append((vp.launch_key, {
                "var": vp,
                "node": node,
                "lower": lowers,
                "chain_bit0": curs[:, 0].copy(),
                "end_bit": end_bit,
                "curs": curs,
                "states0": bst[np.minimum(first_batch, n_batches - 1), v].astype(np.int64),
                "body_n": np.clip(count_v - boundaries, 0, CHAIN_N),
                "moment0": moment0,
            }))
        mode = meta.mode
        table = None
        if mode.kind == Mode.DICT:
            table = dec.dict_table(nt, mode.payload)
        entries.append((nt, ChunkPlan(
            n_pages=n_chains, page_ns=page_ns, page_n=CHAIN_N, delta=meta.delta_encoding, mode_kind=mode.kind,
            mode_scalar=int(mode.payload) if mode.kind in (Mode.INT_MULT, Mode.FLOAT_MULT, Mode.FLOAT_QUANT) else 0,
            var_plans=var_plans, dict_table=table,
            flat=meta.delta_encoding.kind in (DeltaEncoding.LOOKBACK, DeltaEncoding.CONV1),
        ), items))
        ci += 1
        n_seen += n
        if max_n is not None and n_seen >= max_n:
            break
    return fd.uniform_type


def _plan(data: bytes, nt, entries) -> ContainerPlan:
    groups: Dict[tuple, list] = {}
    for _, _, items in entries:
        for lkey, item in items:
            groups.setdefault(lkey, []).append(item)
    return _finish_plan(data, nt, [chunk for _, chunk, _ in entries], groups)


def plan_standalone(data: bytes) -> ContainerPlan:
    """Chain-major decode plan of a standalone `.pco` file (the JAX
    `plan_standalone` without its host fallbacks and fetch limit): every
    chunk walked once on the host, cut into chains of CHAIN_N numbers, and
    decoded as the last chunk's number type (as JAX's)."""
    entries = []
    nt = _walk(data, None, entries)
    if entries:
        nt = entries[-1][0]
    elif nt is None:  # a file of no chunk and no uniform type
        nt = number_type_from_np(np.dtype(np.float64))
    return _plan(data, nt, entries)


def plan_standalone_runs(data: bytes, max_n: Optional[int] = None):
    """A plan for each run of consecutive chunks of one number type, each
    decoded as its own type: what the host's simple_decompress_into reads
    chunk by chunk (the C ABI's decode). A file that simple_compress wrote
    is one run; a file of no chunk, no run. `max_n`: see `_walk`.

    Returns (plans, error): a chunk the walk cannot read ends it, `error`
    is what it raised (else None), and the plans hold the chunks before it,
    the numbers the host's decode has written when it raises."""
    entries = []
    try:
        _walk(data, max_n, entries)
        error = None
    except Exception as e:  # handed to the caller with the chunks walked before it
        error = e
    runs: List[list] = []
    for e in entries:
        if runs and runs[-1][-1][0] is e[0]:
            runs[-1].append(e)
        else:
            runs.append([e])
    return [_plan(data, run[0][0], run) for run in runs], error


def decode_standalone_device(data: bytes, device="cuda") -> np.ndarray:
    """Decode a standalone `.pco` file on `device` (the GPU unless the
    caller asks for the CPU); returns the numbers as a numpy array of the
    file's type."""
    device = _resolve_device(device)
    plan = plan_standalone(data)
    return to_numbers(decode_plan(plan, upload_plan(plan, device)), plan.nt)


def decode_standalone_with_device(data: bytes, time_it: bool = False, device="cuda"):
    """The CLI's standalone decode (the JAX `decode_standalone_with_device`,
    here on K1-K4): returns (numbers, device seconds). With time_it the
    device part (upload to result, the plan excluded) runs again and its
    seconds are returned, else 0.0."""
    device = _resolve_device(device)
    plan = plan_standalone(data)
    bits = decode_plan(plan, upload_plan(plan, device))
    seconds = 0.0
    if time_it:
        sync = torch.cuda.synchronize if device.type == "cuda" else (lambda d: None)
        sync(device)
        t0 = time.perf_counter()
        bits = decode_plan(plan, upload_plan(plan, device))
        sync(device)
        seconds = time.perf_counter() - t0
    return to_numbers(bits, plan.nt), seconds
