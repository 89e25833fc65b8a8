"""Plain-PyTorch helpers of the PCT decode and the K3/K4 wrappers.

The counterparts of the XLA helpers in the JAX package's
`pcodec_tpu/ops/decode.py` and of the post-processing of
`pcodec_tpu/ops/pallas_decode.py`:

    bijections        latent <-> memory bits of every number type
    join_mem          the mode joins (Classic, IntMult, FloatQuant, FloatMult),
                      B3's plain version's
    post_rows         B3, CUDA (csrc/chunk_post.cu): the decode post of
                      every chunk a post table names in one launch, a warp
                      a page: each var's consecutive delta undone (u64
                      carries, warp scans), the ragged last page trimmed,
                      the mode join (FloatMult's through B2's per-number
                      join) into the output, or a Dict chunk's latents into
                      K4's scratch
    float_mult_join   B2, CUDA (csrc/float_mult_join.cu): the FloatMult join
                      of one chunk in one elementwise pass, the integer
                      softfloat's multiply inside; B3 runs its per-number
                      join (csrc/softfloat.cuh), so no decode launches it
    dict_join_chunks  K4, CUDA (csrc/dict_join.cu): the Dict join of every
                      Dict chunk of a container in one launch, a clamped
                      gather of each entry's memory bits; dict_join is its
                      one-chunk case
    consecutive_decode_batched
                      delta reconstruction in plain torch (XLA in JAX), the
                      plain version of B3's delta
    conv1_recon_chunks
                      B1, CUDA (csrc/conv1_recon.cu): the conv1 recurrence
                      of every conv1 var of a container in one call, a
                      thread a row (a warp a row where there are no more
                      rows than warp schedulers), from a descriptor table;
                      conv1_decode_pages is one chunk's rows
    lookback_recon_chunks
                      K3, CUDA (csrc/lookback_recon.cu): lookback
                      reconstruction by pointer doubling of every lookback
                      var of a container in one launch, from a descriptor
                      table, the Classic join folded into its store;
                      lookback_recon is one chunk's pages

u64 values travel as int64 tensors holding the same bits: add, multiply and
cumsum wrap mod 2^64 exactly; unsigned compares go through `_ult`, logical
right shifts mask after the shift. Each kernel wrapper takes its plain
version only for CPU tensors; for CUDA tensors it launches the kernel or
raises.
"""

import numpy as np
import torch

from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_NAME, NumberType
from pcodec_tpu_torch.format.metadata import Mode
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops import softfloat as sf
from pcodec_tpu_torch.ops.softfloat import _MIN64, _i64, _ult  # noqa: F401 (_MIN64 re-exported to the kernel modules)


def _u64_to_tensor(a: np.ndarray, device=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint64).view(np.int64)).to(device)


def _check_cuda(*pairs):
    dev = pairs[0][0].device
    for t, dtype in pairs:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"kernel argument must be a contiguous {dtype} tensor on {dev}, "
                f"got {t.dtype} on {t.device}"
            )


# ---------------------------------------------------------------------------
# bijections (the JAX `_mask_of`, `_from_latent_ordered_u`)
# ---------------------------------------------------------------------------


def mask_of(bits: int) -> int:
    return _i64((1 << bits) - 1)


# K3's join kinds: a row's latents out as they are, or the memory bits of an
# unsigned, signed or float number (must match csrc/lookback_recon.cu)
JOIN_LATENTS, JOIN_UNSIGNED, JOIN_SIGNED, JOIN_FLOAT = range(4)
JOIN_OF_KIND = {"unsigned": JOIN_UNSIGNED, "signed": JOIN_SIGNED, "float": JOIN_FLOAT}


def ordered_join(join: int, bits: int, lat):
    """latent -> memory bits of a number of `bits` bits whose kind is the
    join kind (JOIN_LATENTS: the latents as they are)."""
    if join == JOIN_LATENTS:
        return lat
    mask = mask_of(bits)
    lat = lat & mask
    if join == JOIN_UNSIGNED:
        return lat
    mid = _i64(1 << (bits - 1))
    if join == JOIN_SIGNED:
        return (lat ^ mid) & mask
    return torch.where((lat & mid) != 0, lat ^ mid, (~lat) & mask)


def from_latent_ordered(nt: NumberType, lat):
    """latent -> memory bits of the number (the Classic join)."""
    return ordered_join(JOIN_OF_KIND[nt.kind], nt.latent.bits, lat)


def from_latent_ordered_int(nt: NumberType, lat: int) -> int:
    """`from_latent_ordered` of one python int (a mode's scalar), as int64."""
    bits, join = nt.latent.bits, JOIN_OF_KIND[nt.kind]
    mask, mid = (1 << bits) - 1, 1 << (bits - 1)
    lat &= mask
    if join == JOIN_SIGNED:
        lat ^= mid
    elif join == JOIN_FLOAT:
        lat = lat ^ mid if lat & mid else ~lat & mask
    return _i64(lat)


# ---------------------------------------------------------------------------
# mode joins
# ---------------------------------------------------------------------------


def join_mem(nt: NumberType, mode_kind: str, mode_scalar: int, primary, secondary, out=None):
    """Mode join -> memory bits of the numbers (int64): the JAX `_join_mem`
    without its Dict branch (dict_join takes that). `mode_scalar` is the
    mode's payload as a python int (base latent, or k for FloatQuant).
    With `out` the bits are written into it and it is returned.

    FloatMult (float_mult_join, B2 on the card) multiplies in the integer
    softfloat for every float width, as JAX does for f64 only: the card's
    native f16/f32 multiply gives other bits than the host's (x86) multiply
    on some inputs (NaN multipliers among them), and the decode must give
    the host's numbers bit for bit."""
    bits = nt.latent.bits
    mask = mask_of(bits)
    if mode_kind == Mode.CLASSIC:
        u_latent = primary & mask
    elif mode_kind == Mode.INT_MULT:
        u_latent = ((primary & mask) * _i64(mode_scalar) + (secondary & mask)) & mask
    elif mode_kind == Mode.FLOAT_QUANT:
        k = int(mode_scalar)
        y = primary & mask
        m = secondary & mask
        sign_cutoff = torch.full_like(y, (1 << (bits - 1)) >> k)
        low_max = ((1 << k) - 1) & ((1 << bits) - 1)
        lowest = torch.where(_ult(y, sign_cutoff), _i64(low_max) - m, m)
        u_latent = ((y << k) + lowest) & mask
    elif mode_kind == Mode.FLOAT_MULT:
        return float_mult_join(nt, mode_scalar, primary, secondary, out)
    else:
        raise NotImplementedError(f"{mode_kind} mode has no join here")
    res = from_latent_ordered(nt, u_latent)
    return res if out is None else out.copy_(res)


def float_mult_join_plain(nt: NumberType, base_latent: int, primary, secondary, out=None):
    """Plain version of B2: the FloatMult join in torch ops, the integer
    softfloat's multiply (`ops/softfloat.py`) for every width. Returns the
    memory bits, written into `out` when it is given."""
    bits = nt.latent.bits
    mask = mask_of(bits)
    mid = _i64(1 << (bits - 1))
    P = nt.mantissa_digits
    base_bits = torch.full_like(primary, from_latent_ordered_int(nt, base_latent))
    mult_bits = sf.int_float_latent_to_bits(primary & mask, bits, bits - P, P)
    unadj_lat = sf.ordered_from_bits(sf.sf_mul_bits(mult_bits, base_bits, bits, bits - P, P), bits)
    res = from_latent_ordered(nt, (unadj_lat + (secondary & mask) + mid) & mask)
    return res if out is None else out.copy_(res)


def float_mult_join(nt: NumberType, base_latent: int, primary, secondary, out=None):
    """B2: the FloatMult join of one chunk's flat primary and secondary
    latents (int64) -> memory bits, written into `out` (a slice of the
    container's output) when it is given, else into a new tensor."""
    if primary.device.type == "cpu":
        return float_mult_join_plain(nt, base_latent, primary, secondary, out)
    if primary.dim() != 1 or secondary.shape != primary.shape or nt.latent.bits not in (16, 32, 64):
        raise ValueError("float_mult_join needs flat primary and secondary latents of one float type")
    if out is None:
        out = torch.empty_like(primary)
    if out.shape != primary.shape:
        raise ValueError("float_mult_join: out must have the latents' shape")
    _check_cuda((primary, torch.int64), (secondary, torch.int64), (out, torch.int64))
    kernels.launch_float_mult_join(primary, secondary, from_latent_ordered_int(nt, base_latent), out,
                                   nt.latent.bits)
    return out


def dict_table(nt: NumberType, dict_vals: np.ndarray) -> np.ndarray:
    """Each dictionary entry's memory bits (int64), the latent->memory
    bijection folded in (the JAX `_dict_mem_planes` without its planes)."""
    lat = _u64_to_tensor(np.asarray(dict_vals).astype(np.uint64))
    return from_latent_ordered(nt, lat).numpy()


def dict_join_plain(primary: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 on one chunk: memory bits
    table[min(primary & 0xFFFFFFFF, D - 1)]."""
    idx = torch.clamp(primary & 0xFFFFFFFF, max=table.shape[0] - 1)
    return table[idx]


def dict_join_chunks_plain(bases, desc: np.ndarray, table: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 over every Dict chunk of a container, into `out`.

    bases: the int64 tensors the chunks' index latents lie in (a launch
    output, or a chunk's latents reconstructed under a delta); desc (C, 6)
    int64 rows (base, start, n, out offset, table offset, D): the chunk's
    latents are the flat elements [start, start + n) of bases[base], and
    out[off : off + n] = dict_join_plain(latents, table[toff : toff + D]).
    Returns out."""
    for b, start, n, off, toff, D in np.asarray(desc, np.int64).reshape(-1, 6).tolist():
        out[off : off + n] = dict_join_plain(bases[b].reshape(-1)[start : start + n], table[toff : toff + D])
    return out


def dict_join_chunks(bases, desc: np.ndarray, table: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """K4: every Dict chunk of a container joined by one launch, straight
    into the container's output; arguments as dict_join_chunks_plain."""
    if out.device.type == "cpu":
        return dict_join_chunks_plain(bases, desc, table, out)
    if out.dim() != 1 or table.dim() != 1:
        raise ValueError("dict_join_chunks needs a flat table and a flat output")
    _check_cuda((out, torch.int64), (table, torch.int64), *((b, torch.int64) for b in bases))
    kernels.launch_dict_join(bases, desc, table, out)
    return out


def dict_join(primary: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """K4 on one chunk: primary (n,) int64 index latents, table (D,) int64
    memory bits -> (n,) int64 memory bits; the one-chunk case of
    dict_join_chunks."""
    if primary.device.type == "cpu":
        return dict_join_plain(primary, table)
    if primary.dim() != 1 or table.dim() != 1 or table.shape[0] < 1:
        raise ValueError("dict_join needs a flat primary and a non-empty flat table")
    out = torch.empty_like(primary)
    return dict_join_chunks([primary], np.array([[0, 0, primary.shape[0], 0, 0, table.shape[0]]]), table, out)


# ---------------------------------------------------------------------------
# delta reconstruction
# ---------------------------------------------------------------------------


def consecutive_decode_batched(latents, moments, order: int, latent_bits: int):
    """latents (P, N) and moments (P, order), u64 bits in int64; toggle
    center + cascaded exclusive cumsums (the JAX `_consecutive_decode_batched`)."""
    out = latents + _i64(1 << (latent_bits - 1))
    z = torch.zeros((latents.shape[0], 1), dtype=torch.int64, device=latents.device)
    for j in range(order - 1, -1, -1):
        cs = torch.cumsum(out, dim=1)
        out = moments[:, j : j + 1] + torch.cat([z, cs[:, :-1]], dim=1)
    return out


# B3's descriptor table: one row per chunk of a container's post,
# POST_DESC_COLS int64 columns (must match csrc/chunk_post.cu). Per var
# (prim_, sec_): a base (an index into the call's `bases`; -1 a trivial var
# whose every latent is its start) and start, the chunk's number i at start
# + i; its consecutive order (0: no delta) and where its pages' moments
# start in base mom_base (page p's order moments at mom + p * order); its
# latent bits. The chunk's n_valid numbers go to out_start + i of out_base
# after the join; page_n is the delta's page, seg_n the numbers an item
# (a warp) takes (page_n where a var has a delta), item0 the row's first
# item in the launch. mode indexes POST_MODES; join is a JOIN_ kind
# (JOIN_LATENTS: the primary's values as they are); bits the number's
# latent bits; scalar the mode's (IntMult base, FloatQuant k, FloatMult
# base latent). A Classic row reads no secondary.
POST_COLS = ("prim_base", "prim_start", "prim_order", "prim_mom", "prim_bits", "sec_base", "sec_start", "sec_order",
             "sec_mom", "sec_bits", "mom_base", "out_base", "out_start", "n_valid", "page_n", "seg_n", "item0",
             "mode", "join", "bits", "scalar")
POST_DESC_COLS = len(POST_COLS)
POST_MODES = (Mode.CLASSIC, Mode.INT_MULT, Mode.FLOAT_QUANT, Mode.FLOAT_MULT)  # a row's mode code: the index
POST_SEG_N = 1024  # numbers an item of a row without a delta takes
_KIND_OF_JOIN = {JOIN_UNSIGNED: "u", JOIN_SIGNED: "i", JOIN_FLOAT: "f"}


def post_row(prim, sec, mom_base: int, out, n_valid: int, page_n: int, item0: int, mode: str, join: int, bits: int,
             scalar: int) -> list:
    """One B3 descriptor row: prim and sec (base, start, order, moments
    offset, latent bits) of the vars, out (base, start)."""
    seg_n = page_n if prim[2] or (mode != Mode.CLASSIC and sec[2]) else POST_SEG_N
    return [*prim, *sec, mom_base, *out, n_valid, page_n, seg_n, item0, POST_MODES.index(mode), join, bits,
            _i64(scalar)]


def post_items(desc: np.ndarray) -> int:
    """The items (warps) of B3's launch over desc's rows."""
    d = np.asarray(desc, np.int64).reshape(-1, POST_DESC_COLS)
    return int((-(-d[:, _PC["n_valid"]] // d[:, _PC["seg_n"]])).sum())


_PC = {name: i for i, name in enumerate(POST_COLS)}


def post_var_latents(bases, r: list, var: str) -> torch.Tensor:
    """A B3 row's var ("prim" or "sec") as its n_valid latents: its pages
    (zero past n_valid) through consecutive_decode_batched at its order,
    trimmed."""
    n, N = r[_PC["n_valid"]], r[_PC["page_n"]]
    P = -(-n // N)
    base, start, order, bits = (r[_PC[f"{var}_{k}"]] for k in ("base", "start", "order", "bits"))
    if base < 0:
        lat = torch.full((P, N), start, dtype=torch.int64, device=bases[r[_PC["out_base"]]].device)
    else:
        flat = bases[base].reshape(-1)[start : start + n]
        lat = torch.cat([flat, flat.new_zeros(P * N - n)]).view(P, N)
    if order:
        mom = bases[r[_PC["mom_base"]]].reshape(-1)[r[_PC[f"{var}_mom"]] :][: P * order].view(P, order)
        lat = consecutive_decode_batched(lat, mom, order, bits)
    return lat.reshape(-1)[:n]


def post_row_type(r: list) -> NumberType:
    """The number type of a B3 row that joins (join not JOIN_LATENTS)."""
    return NUMBER_TYPES_BY_NAME[_KIND_OF_JOIN[r[_PC["join"]]] + str(r[_PC["bits"]])]


def post_rows_plain(bases, desc: np.ndarray, desc_dev=None):
    """Plain version of B3 over a post table: for each row, each var's
    latents (post_var_latents), then join_mem of the row's mode (a
    JOIN_LATENTS row: the primary as it is) into its output base. desc_dev
    is not read. Returns nothing; the output bases are written in place."""
    for r in np.asarray(desc, np.int64).reshape(-1, POST_DESC_COLS).tolist():
        n, mode, scalar = r[_PC["n_valid"]], POST_MODES[r[_PC["mode"]]], r[_PC["scalar"]]
        dst = bases[r[_PC["out_base"]]].reshape(-1)[r[_PC["out_start"]] : r[_PC["out_start"]] + n]
        prim = post_var_latents(bases, r, "prim")
        if r[_PC["join"]] == JOIN_LATENTS:
            dst.copy_(prim)
            continue
        sec = None if mode == Mode.CLASSIC else post_var_latents(bases, r, "sec")
        if mode == Mode.FLOAT_MULT:  # B2's plain version, on any device
            float_mult_join_plain(post_row_type(r), scalar, prim, sec, dst)
        else:
            join_mem(post_row_type(r), mode, scalar, prim, sec, dst)


def post_rows(bases, desc: np.ndarray, desc_dev=None):
    """B3: every row of a container's post table by one launch, straight
    into the rows' outputs; arguments as post_rows_plain, desc_dev the rows
    on the card (uploaded here when None)."""
    if all(b.device.type == "cpu" for b in bases):
        return post_rows_plain(bases, desc)
    desc = np.ascontiguousarray(desc, dtype=np.int64).reshape(-1, POST_DESC_COLS)
    if len(bases) > kernels.POST_MAX_BASES:
        raise ValueError(f"post_rows reads at most {kernels.POST_MAX_BASES} tensors a launch")
    _check_cuda(*((b, torch.int64) for b in bases))
    if desc_dev is None:
        desc_dev = torch.from_numpy(desc).to(bases[0].device)
    _check_cuda((desc_dev, torch.int64))
    if desc_dev.device != bases[0].device or tuple(desc_dev.shape) != desc.shape:
        raise ValueError("post_rows: desc_dev must hold desc's rows on the bases' device")
    kernels.launch_chunk_post(bases, desc, desc_dev)


def lookback_rounds(page_n: int) -> int:
    """Pointer-doubling rounds that resolve any page of page_n numbers."""
    return max(page_n - 1, 1).bit_length()


def lookback_decode_pages_plain(latents, lookbacks, moments, window_n: int, state_n: int, bits: int):
    """Plain version of K3: the JAX prologue of `_lookback_decode_pages_pallas`
    plus `xops._lookback_decode`, batched over pages.

    latents (P, N) u64 latents of the var, lookbacks (P, N) the `delta`
    var's latents (only the first N - state_n are read), moments
    (P, state_n) the stored state. Position p < state_n is the stored
    state; after it value[p] = delta[p - state_n] + value[p - lb], lb the
    lookback at p - state_n clipped to [1, window_n], a reference before the
    page reading the zero prefill. Returns (P, N) int64."""
    P, N = latents.shape
    s = min(state_n, N)
    deltas = latents[:, : N - s] + _i64(1 << (bits - 1))
    add = torch.cat([moments[:, :s], deltas], dim=1)
    lb = torch.clamp(lookbacks[:, : N - s], 1, window_n)
    pos = torch.arange(s, N, device=latents.device, dtype=torch.int64)[None, :]
    ptr = torch.cat([torch.full((P, s), -1, dtype=torch.int64, device=latents.device),
                     torch.clamp(pos - lb, min=-1)], dim=1)
    for _ in range(lookback_rounds(N)):
        active = ptr >= 0
        j = torch.clamp(ptr, min=0)
        add = torch.where(active, add + torch.gather(add, 1, j), add)
        ptr = torch.where(active, torch.gather(ptr, 1, j), ptr)
    return add


# K3's descriptor table: one row per lookback var of a chunk, DESC_COLS
# int64 columns (must match csrc/lookback_recon.cu). A base is an index into
# the call's `bases`; a lat or lb base of -1 is a trivial var whose every
# latent is its start. Page p of the row reads latents and lookbacks at
# start + p * page_n and its state at mom_start + p * state_n; number i <
# n_valid of the row (its pages' numbers, in order) goes to out_start + i
# after its join. page0 is the row's first page in the launch (the sum of the rows'
# pages before it).
LB_COLS = ("lat_base", "lat_start", "lb_base", "lb_start", "mom_base", "mom_start", "out_base", "out_start",
           "n_pages", "page_n", "n_valid", "state_n", "window_n", "bits", "join", "page0")
LB_DESC_COLS = len(LB_COLS)


def lookback_recon_chunks_plain(bases, desc: np.ndarray, desc_dev=None):
    """Plain version of K3 over a container's lookback table: for each row,
    lookback_decode_pages_plain of its pages, the first n_valid numbers, each
    through the row's join, written into its output base. desc_dev (the
    rows on the kernel's device) is not read. Returns nothing; the output
    bases are written in place."""
    c = {name: i for i, name in enumerate(LB_COLS)}
    for r in np.asarray(desc, np.int64).reshape(-1, LB_DESC_COLS).tolist():
        P, N, n, state_n = r[c["n_pages"]], r[c["page_n"]], r[c["n_valid"]], r[c["state_n"]]

        def pages(base, start):
            if base < 0:
                return torch.full((P, N), start, dtype=torch.int64, device=bases[r[c["out_base"]]].device)
            flat = bases[base].reshape(-1)[start : start + n]
            return torch.cat([flat, flat.new_zeros(P * N - n)]).view(P, N)

        mom = bases[r[c["mom_base"]]].reshape(-1)[r[c["mom_start"]] :][: P * state_n].view(P, state_n)
        add = lookback_decode_pages_plain(pages(r[c["lat_base"]], r[c["lat_start"]]),
                                          pages(r[c["lb_base"]], r[c["lb_start"]]), mom, r[c["window_n"]],
                                          state_n, r[c["bits"]])
        out = bases[r[c["out_base"]]].reshape(-1)
        out[r[c["out_start"]] : r[c["out_start"]] + n] = ordered_join(r[c["join"]], r[c["bits"]],
                                                                      add.reshape(-1)[:n])


def _lookback_table(name: str, bases, desc: np.ndarray, desc_dev):
    """desc as (R, LB_DESC_COLS) int64 rows and desc_dev the same rows on
    the bases' card (uploaded where None), the bases checked."""
    desc = np.ascontiguousarray(desc, dtype=np.int64).reshape(-1, LB_DESC_COLS)
    if len(bases) > kernels.LB_MAX_BASES:
        raise ValueError(f"{name} reads at most {kernels.LB_MAX_BASES} tensors a launch")
    _check_cuda(*((b, torch.int64) for b in bases))
    dev = bases[0].device
    if desc_dev is None:
        desc_dev = torch.from_numpy(desc).to(dev)
    _check_cuda((desc_dev, torch.int64))
    if desc_dev.device != dev or tuple(desc_dev.shape) != desc.shape:
        raise ValueError(f"{name}: desc_dev must hold desc's rows on the bases' device")
    return desc, desc_dev


def lookback_recon_chunks(bases, desc: np.ndarray, desc_dev=None):
    """K3: every row of a container's lookback table (pages of at most
    kernels.LB_SMEM_MAX_N numbers) reconstructed by one launch, straight
    into the rows' outputs; arguments as lookback_recon_chunks_plain,
    desc_dev the rows on the card (uploaded here when None)."""
    if all(b.device.type == "cpu" for b in bases):
        return lookback_recon_chunks_plain(bases, desc)
    desc, desc_dev = _lookback_table("lookback_recon_chunks", bases, desc, desc_dev)
    kernels.launch_lookback_chunks(bases, desc, desc_dev)


def lookback_tiles(bases, desc: np.ndarray, desc_dev=None):
    """B7: every row of a lookback table whose rows store latents
    (JOIN_LATENTS), pages of any length, reconstructed by one launch in
    tiles of kernels.LB_SMEM_MAX_N numbers, a tile waiting for its page's
    earlier tiles' final numbers; arguments as lookback_recon_chunks_plain,
    its plain version."""
    if all(b.device.type == "cpu" for b in bases):
        return lookback_recon_chunks_plain(bases, desc)
    desc, desc_dev = _lookback_table("lookback_tiles", bases, desc, desc_dev)
    c = {name: i for i, name in enumerate(LB_COLS)}
    tiles = -(-int(desc[:, c["page_n"]].max(initial=0)) // kernels.LB_SMEM_MAX_N)
    sync = torch.empty(1 + int(desc[:, c["n_pages"]].sum()) * tiles, dtype=torch.int32, device=bases[0].device)
    kernels.launch_lookback_tiles(bases, desc, desc_dev, sync)


def lookback_recon(latents, lookbacks, moments, window_n: int, state_n: int, bits: int):
    """K3 on one chunk's pages; arguments as lookback_decode_pages_plain:
    a one-row table of lookback_recon_chunks (pages of at most
    kernels.LB_SMEM_MAX_N numbers, a block a page in shared memory) or of
    lookback_tiles (longer pages)."""
    if latents.device.type == "cpu":
        return lookback_decode_pages_plain(latents, lookbacks, moments, window_n, state_n, bits)
    P, N = latents.shape
    if lookbacks.shape != (P, N) or moments.shape != (P, state_n) or window_n < 1 or not 0 < bits <= 64:
        raise ValueError("lookback_recon: argument shapes do not match the pages")
    _check_cuda((latents, torch.int64), (lookbacks, torch.int64), (moments, torch.int64))
    out = torch.empty_like(latents)
    row = [0, 0, 1, 0, 2, 0, 3, 0, P, N, P * N, state_n, window_n, bits, JOIN_LATENTS, 0]
    table = lookback_recon_chunks if N <= kernels.LB_SMEM_MAX_N else lookback_tiles
    table([latents, lookbacks, moments, out], np.array([row], np.int64))
    return out


def conv1_decode_pages_plain(latents, moments, weights, quantization: int, bias: int, order: int, bits: int):
    """Plain version of B1: `xops._conv1_decode` batched over rows, a loop
    over positions with all rows as the batch. latents (P, N), moments (P,
    order). value[p] = delta[p - order] + mid + (max(bias + sum_j w_j
    value[p - order + j], 0) >> quantization) in wrapping signed 64-bit
    arithmetic, masked to `bits`; the first `order` outputs are the stored
    state."""
    P, N = latents.shape
    mid = _i64(1 << (bits - 1))
    mask = mask_of(bits)
    w = torch.tensor(list(weights), dtype=torch.int64, device=latents.device)[None, :]
    out = torch.empty((P, N), dtype=torch.int64, device=latents.device)
    k = min(order, N)
    out[:, :k] = moments[:, :k]
    base = latents + mid
    for p in range(order, N):
        s = bias + (w * out[:, p - order : p]).sum(dim=1)
        out[:, p] = (base[:, p - order] + (torch.clamp(s, min=0) >> quantization)) & mask
    out[:, :k] &= mask  # the state itself, unmasked, fed the first predictions
    return out


# B1's descriptor table: one row per conv1 var of a chunk, C1_DESC_COLS int64
# columns, the last 32 the weights (must match csrc/conv1_recon.cu). A base
# is an index into the call's `bases`; a lat base of -1 is a trivial var
# whose every latent is lat_start. Row r of the entry reads its latents at
# lat_start + r * row_n and its state at mom_start + r * order; number i <
# n_valid of the entry (its rows' numbers, in order) goes to out_start + i.
# row0 is the entry's first row in the call (the sum of the rows before it).
# narrow (conv1_narrow) routes the entry's steps after its first `order` to
# the kernel's 32-bit window; the C side refuses a narrow row outside it.
C1_COLS = ("lat_base", "lat_start", "mom_base", "mom_start", "out_base", "out_start", "n_rows", "row_n",
           "n_valid", "order", "quant", "bias", "bits", "row0", "narrow") + tuple(f"w{j}" for j in range(32))
C1_DESC_COLS = len(C1_COLS)
C1_MAX_ORDER = 32
# conv1's signed arithmetic width for each latent width (dtypes.LatentType.conv_dtype)
C1_CONV_BITS = {8: 16, 16: 32, 32: 64}


def conv1_narrow(weights, quantization: int, bias: int, bits: int) -> bool:
    """Whether B1 may step a row in narrow arithmetic: latents of 8, 16 or
    32 bits, q <= conv_bits - 1 and |bias| + 2^bits * sum|w| <
    2^(conv_bits - 1), in exact integers (ChunkMeta.validate's bound, there
    in floats). Then every partial sum over a window of values below 2^bits
    fits conv_bits - 1 signed bits."""
    conv_bits = C1_CONV_BITS.get(bits)
    return (conv_bits is not None and 0 <= quantization <= conv_bits - 1
            and abs(int(bias)) + (sum(abs(int(w)) for w in weights) << bits) < 1 << (conv_bits - 1))


def conv1_row(weights, quantization: int, bias: int, bits: int, n_rows: int, row_n: int, n_valid: int, row0: int,
              lat=(-1, 0), mom=(0, 0), out=(0, 0)) -> list:
    """One B1 descriptor row of order len(weights): (base, start) pairs of
    its latents, state and output; narrow where conv1_narrow admits it."""
    w = [int(x) for x in weights]
    return [*lat, *mom, *out, n_rows, row_n, n_valid, len(w), quantization, bias, bits, row0,
            int(conv1_narrow(w, quantization, bias, bits)), *w, *[0] * (C1_MAX_ORDER - len(w))]


def conv1_row_pages(bases, r):
    """A B1 row's latents (n_rows, row_n) (zero past n_valid) and stored
    state (n_rows, order) as int64 tensors."""
    c = {name: i for i, name in enumerate(C1_COLS)}
    P, N, n, k = r[c["n_rows"]], r[c["row_n"]], r[c["n_valid"]], r[c["order"]]
    dev = bases[r[c["out_base"]]].device
    if r[c["lat_base"]] < 0:
        lat = torch.full((P, N), r[c["lat_start"]], dtype=torch.int64, device=dev)
    else:
        flat = bases[r[c["lat_base"]]].reshape(-1)[r[c["lat_start"]] : r[c["lat_start"]] + n]
        lat = torch.cat([flat, flat.new_zeros(P * N - n)]).view(P, N)
    mom = bases[r[c["mom_base"]]].reshape(-1)[r[c["mom_start"]] : r[c["mom_start"]] + P * k].view(P, k)
    return lat, mom


def conv1_recon_chunks_plain(bases, desc: np.ndarray, desc_dev=None):
    """Plain version of B1 over a container's conv1 table: for each row,
    conv1_decode_pages_plain of its rows, the first n_valid numbers written
    into its output base. desc_dev is not read. Returns nothing; the output
    bases are written in place."""
    c = {name: i for i, name in enumerate(C1_COLS)}
    for r in np.asarray(desc, np.int64).reshape(-1, C1_DESC_COLS).tolist():
        lat, mom = conv1_row_pages(bases, r)
        k, n = r[c["order"]], r[c["n_valid"]]
        vals = conv1_decode_pages_plain(lat, mom, r[c["w0"] : c["w0"] + k], r[c["quant"]], r[c["bias"]], k,
                                        r[c["bits"]])
        out = bases[r[c["out_base"]]].reshape(-1)
        out[r[c["out_start"]] : r[c["out_start"]] + n] = vals.reshape(-1)[:n]


def conv1_recon_chunks(bases, desc: np.ndarray, desc_dev=None):
    """B1: every row of a container's conv1 table reconstructed by one
    launch for each order it holds, straight into the rows' outputs;
    arguments as conv1_recon_chunks_plain, desc_dev the rows on the card
    (uploaded here when None)."""
    if all(b.device.type == "cpu" for b in bases):
        return conv1_recon_chunks_plain(bases, desc)
    desc = np.ascontiguousarray(desc, dtype=np.int64).reshape(-1, C1_DESC_COLS)
    if len(bases) > kernels.C1_MAX_BASES:
        raise ValueError(f"conv1_recon_chunks reads at most {kernels.C1_MAX_BASES} tensors a call")
    _check_cuda(*((b, torch.int64) for b in bases))
    if desc_dev is None:
        desc_dev = torch.from_numpy(desc).to(bases[0].device)
    _check_cuda((desc_dev, torch.int64))
    if desc_dev.device != bases[0].device or tuple(desc_dev.shape) != desc.shape:
        raise ValueError("conv1_recon_chunks: desc_dev must hold desc's rows on the bases' device")
    kernels.launch_conv1_recon(bases, desc, desc_dev)


def conv1_decode_pages(latents, moments, weights, quantization: int, bias: int, order: int, bits: int):
    """B1 on one chunk's rows; arguments as conv1_decode_pages_plain. On the
    card a one-entry table of conv1_recon_chunks."""
    if latents.device.type == "cpu":
        return conv1_decode_pages_plain(latents, moments, weights, quantization, bias, order, bits)
    P, N = latents.shape
    if moments.shape != (P, order) or len(weights) != order or not 1 <= order <= C1_MAX_ORDER:
        raise ValueError("conv1_decode_pages: argument shapes do not match the rows and order")
    out = torch.empty_like(latents)
    row = conv1_row(weights, quantization, bias, bits, P, N, P * N, 0, lat=(0, 0), mom=(1, 0), out=(2, 0))
    conv1_recon_chunks([latents, moments, out], np.array([row], np.int64))
    return out
