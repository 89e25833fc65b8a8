"""quantile-compression (.qco, q_compress 0.11.x) — the reference's frozen
predecessor codec, reimplemented from scratch.

Format (ref: quantile-compression/q_compress/src/):
  header  = b"qco!" + dtype byte + flag bytes (7 data bits + 1 continuation
            bit per byte; flags.rs)
  chunk   = b"," + [n:24][compressed_body_size:32][delta moments raw]
            + prefixes + byte-pad, then the Huffman-coded body
            (chunk_metadata.rs, base_compressor.rs)
  footer  = b"."
All bit packing is MSB-first within bytes (bits.rs). Each prefix pairs a
Huffman code with a numeric range [lower, upper]; a number is coded as its
prefix's code, an optional run-length varint (run_len_utils.rs), and an
offset of k or k+1 bits where k = floor(log2((upper-lower)/gcd + 1))
(prefix.rs k_info). Values decode as lower + offset*gcd (gcd_utils.rs).
Delta encoding applies order-many wrapping diffs in the signed space with
per-page "delta moments" (delta_encoding.rs).

This implementation works in Python ints end to end so every width
(u8..u128, 96-bit timestamps, bools) shares one code path; numpy only at
the API boundary. Correctness oracle: the 9 pinned assets in
quantile-compression/q_compress/assets/ (tests/test_qco.py).
"""

import heapq
import math
from itertools import accumulate
from typing import List, Optional

import numpy as np

from pcodec_tpu_torch.errors import (CorruptionError, InsufficientDataError,
                               InvalidArgumentError)

MAGIC = b"qco!"
CHUNK_BYTE = 0x2C
TERM_BYTE = 0x2E
MAX_DELTA_ORDER = 7
BITS_N_ENTRIES = 24
BITS_N_PREFIXES = 15
BITS_JUMPSTART = 5
BITS_BODY_SIZE = 32
MAX_ENTRIES = (1 << 24) - 1
MAX_JUMPSTART = BITS_N_ENTRIES
DEFAULT_LEVEL = 8
MAX_LEVEL = 12
MIN_N_RUN_LEN = 1001
MIN_FREQ_RUN_LEN = 0.8
AUTO_DELTA_LIMIT = 1100
MAX_AUTO_DELTA_LEVEL = 6
DEFAULT_CHUNK_SIZE = 1_000_000


def _corrupt(msg):
    return CorruptionError("qco: " + msg)


# ---------------------------------------------------------------------------
# value spaces (data_types/*.rs)
# ---------------------------------------------------------------------------

class QcoType:
    """One NumberLike impl: raw wire encoding + order-preserving unsigned
    bijection + signed delta space (ref: data_types/mod.rs NumberLike)."""

    def __init__(self, name, header_byte, raw_bits, u_bits, kind,
                 signed_raw_bits=None, ts_min=None):
        self.name = name
        self.header_byte = header_byte
        self.raw_bits = raw_bits          # PHYSICAL_BITS
        self.u_bits = u_bits              # UnsignedLike width
        self.kind = kind                  # int|uint|float|bool|ts96
        # PHYSICAL_BITS of the Signed delta type (i128 for ts96)
        self.signed_raw_bits = signed_raw_bits or u_bits
        # 96-bit timestamps bias their raw encoding by the type's MIN parts
        self.ts_min = ts_min

    # --- number <-> raw wire bits (big-endian, raw_bits wide) ---
    def num_to_raw(self, x):
        b, mask = self.u_bits, (1 << self.u_bits) - 1
        if self.kind == "int":
            return x & mask
        if self.kind == "ts96":
            # raw = (parts - MIN) as u96 (timestamps_96.rs to_bytes)
            return (x - self.ts_min) & ((1 << 96) - 1)
        return x  # uint/float-bits/bool already raw

    def raw_to_num(self, r):
        b = self.u_bits
        if self.kind == "int":
            return r - (1 << b) if r >= (1 << (b - 1)) else r
        if self.kind == "ts96":
            return r + self.ts_min
        if self.kind == "bool":
            return 1 if r else 0
        return r

    # --- number <-> order-preserving unsigned ---
    def to_u(self, x):
        b = self.u_bits
        if self.kind in ("int", "ts96"):
            return (x + (1 << (b - 1))) & ((1 << b) - 1)  # wrapping_sub(MIN)
        if self.kind == "float":
            sign = 1 << (b - 1)
            mask = (1 << b) - 1
            return (~x) & mask if x & sign else x ^ sign
        return x  # uint / bool

    def from_u(self, u):
        b = self.u_bits
        if self.kind in ("int", "ts96"):
            return u - (1 << (b - 1))
        if self.kind == "float":
            sign = 1 << (b - 1)
            mask = (1 << b) - 1
            return u ^ sign if u & sign else (~u) & mask
        if self.kind == "bool":
            return 1 if u else 0
        return u

    # --- number <-> signed delta space (Python signed int; bool = XOR) ---
    def to_s(self, x):
        b = self.u_bits
        if self.kind in ("int", "ts96", "bool"):
            return x
        # uint/float: reinterpret the u_bits pattern as two's complement
        return x - (1 << b) if x >= (1 << (b - 1)) else x

    def from_s(self, s):
        if self.kind in ("int", "ts96", "bool"):
            return s
        return s & ((1 << self.u_bits) - 1)

    # signed-space <-> its unsigned repr (for prefix coding of deltas)
    def s_to_u(self, s):
        if self.kind == "bool":
            return 1 if s else 0
        b = self.u_bits
        return (s + (1 << (b - 1))) & ((1 << b) - 1)

    def u_to_s(self, u):
        if self.kind == "bool":
            return 1 if u else 0
        b = self.u_bits
        return u - (1 << (b - 1))


TS96_MIN = -(1_000_000 << 63)  # TimestampMicros96 MIN parts
TS96_NANOS_MIN = -(1_000_000_000 << 63)

TYPES = {}
for _t in [
    QcoType("i64", 1, 64, 64, "int"),
    QcoType("u64", 2, 64, 64, "uint"),
    QcoType("i32", 3, 32, 32, "int"),
    QcoType("u32", 4, 32, 32, "uint"),
    QcoType("f64", 5, 64, 64, "float"),
    QcoType("f32", 6, 32, 32, "float"),
    QcoType("bool", 7, 8, 8, "bool"),
    QcoType("i128", 10, 128, 128, "int"),
    QcoType("u128", 11, 128, 128, "uint"),
    QcoType("u16", 12, 16, 16, "uint"),
    QcoType("i16", 13, 16, 16, "int"),
    QcoType("timestamp_nanos", 14, 64, 64, "int"),
    QcoType("timestamp_micros", 15, 64, 64, "int"),
    QcoType("timestamp_micros96", 9, 96, 128, "ts96", signed_raw_bits=128,
            ts_min=TS96_MIN),
    QcoType("timestamp_nanos96", 8, 96, 128, "ts96", signed_raw_bits=128,
            ts_min=TS96_NANOS_MIN),
]:
    TYPES[_t.name] = _t
HEADER_BYTE_TO_TYPE = {t.header_byte: t for t in TYPES.values()}

NP_DTYPES = {
    "i64": np.int64, "u64": np.uint64, "i32": np.int32, "u32": np.uint32,
    "f64": np.float64, "f32": np.float32, "bool": np.bool_,
    "u16": np.uint16, "i16": np.int16,
    "timestamp_nanos": np.int64, "timestamp_micros": np.int64,
}


# ---------------------------------------------------------------------------
# MSB-first bit IO (bits.rs / bit_reader.rs / bit_writer.rs)
# ---------------------------------------------------------------------------

class Reader:
    def __init__(self, data: bytes):
        self.data = bytes(data)
        self.total_bits = 8 * len(self.data)
        # zero padding lets the Huffman peek run past EOF; true reads are
        # bounds-checked against total_bits
        self._padded = self.data + b"\x00" * 17
        self.pos = 0

    def _extract(self, pos, n):
        start = pos >> 3
        end = (pos + n + 7) >> 3
        chunk = int.from_bytes(self._padded[start:end], "big")
        return (chunk >> (end * 8 - pos - n)) & ((1 << n) - 1)

    def read_bits(self, n):
        if n == 0:
            return 0
        if self.pos + n > self.total_bits:
            raise InsufficientDataError("qco: out of data")
        v = self._extract(self.pos, n)
        self.pos += n
        return v

    def peek_padded(self, n):
        return self._extract(self.pos, n)

    def read_one(self):
        return self.read_bits(1) == 1

    def read_varint(self, jumpstart):
        res = self.read_bits(jumpstart)
        for i in range(jumpstart, BITS_N_ENTRIES):
            if self.read_one():
                if self.read_one():
                    res |= 1 << i
            else:
                break
        return res

    def aligned_byte_idx(self):
        if self.pos % 8:
            raise _corrupt("misaligned read")
        return self.pos >> 3

    def read_aligned_bytes(self, n):
        i = self.aligned_byte_idx()
        if (i + n) * 8 > self.total_bits:
            raise InsufficientDataError("qco: out of data")
        self.pos += 8 * n
        return self.data[i : i + n]

    def drain_empty_byte(self, msg):
        rem = (-self.pos) % 8
        if rem and self.read_bits(rem) != 0:
            raise _corrupt(msg)


class Writer:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write_bits(self, x, n):
        if n == 0:
            return
        self.acc = (self.acc << n) | (x & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_one(self, b):
        self.write_bits(1 if b else 0, 1)

    def write_varint(self, x, jumpstart):
        self.write_bits(x, jumpstart)
        x >>= jumpstart
        for _ in range(jumpstart, BITS_N_ENTRIES):
            if x > 0:
                self.write_one(True)
                self.write_one(x & 1 > 0)
                x >>= 1
            else:
                break
        self.write_one(False)  # stop bit (bit_writer.rs:161)

    def finish_byte(self):
        if self.nbits:
            self.write_bits(0, 8 - self.nbits)

    def to_bytes(self):
        assert self.nbits == 0
        return bytes(self.buf)

    def byte_size(self):
        return len(self.buf) + (1 if self.nbits else 0)


# ---------------------------------------------------------------------------
# flags (flags.rs)
# ---------------------------------------------------------------------------

class Flags:
    def __init__(self, delta_order=0, use_gcds=True, use_wrapped_mode=False,
                 use_5_bit_code_len=True, use_min_count_encoding=True):
        self.use_5_bit_code_len = use_5_bit_code_len
        self.delta_order = delta_order
        self.use_min_count_encoding = use_min_count_encoding
        self.use_gcds = use_gcds
        self.use_wrapped_mode = use_wrapped_mode

    @classmethod
    def parse_from(cls, r: Reader):
        r.aligned_byte_idx()
        bools = []
        while True:
            byte = r.read_bits(8)
            bools.extend(((byte >> (7 - i)) & 1) == 1 for i in range(7))
            if not (byte & 1):
                break
        f = cls(use_5_bit_code_len=False, use_min_count_encoding=False,
                use_gcds=False)
        it = iter(bools)
        f.use_5_bit_code_len = next(it, False)
        order_bits = [next(it, False) for _ in range(3)]
        f.delta_order = sum(b << (2 - i) for i, b in enumerate(order_bits))
        f.use_min_count_encoding = next(it, False)
        f.use_gcds = next(it, False)
        f.use_wrapped_mode = next(it, False)
        if any(it):
            raise _corrupt("flags from a newer q_compress version")
        return f

    def write(self, w: Writer):
        bools = [self.use_5_bit_code_len]
        bools.extend(((self.delta_order >> (2 - i)) & 1) == 1
                     for i in range(3))
        bools.extend([self.use_min_count_encoding, self.use_gcds,
                      self.use_wrapped_mode])
        while bools and not bools[-1]:
            bools.pop()
        n_bytes = len(bools) // 7 + 1
        for i in range(n_bytes):
            chunk = bools[i * 7 : (i + 1) * 7]
            chunk += [False] * (7 - len(chunk))
            byte = sum(b << (7 - j) for j, b in enumerate(chunk))
            if (i + 1) * 7 < len(bools):
                byte |= 1
            w.write_bits(byte, 8)

    def bits_to_encode_code_len(self):
        return 5 if self.use_5_bit_code_len else 4

    def bits_to_encode_count(self, n):
        if self.use_wrapped_mode:
            return 0
        if self.use_min_count_encoding:
            return math.ceil(math.log2(n + 1))
        return BITS_N_ENTRIES


# ---------------------------------------------------------------------------
# prefixes (prefix.rs, gcd_utils.rs)
# ---------------------------------------------------------------------------

class Prefix:
    __slots__ = ("count", "code", "lower_u", "upper_u", "jumpstart", "gcd",
                 "k", "only_k_lower", "only_k_upper", "min_unambiguous",
                 "most_significant")

    def __init__(self, count, code, lower_u, upper_u, jumpstart, gcd, u_bits):
        self.count = count
        self.code = code  # tuple of 0/1
        self.lower_u = lower_u
        self.upper_u = upper_u
        self.jumpstart = jumpstart
        self.gcd = gcd
        diff = (upper_u - lower_u) // gcd
        # k = floor(log2(diff+1)) in f64 arithmetic (prefix.rs k_info)
        self.k = int(math.floor(math.log2(float(diff) + 1.0)))
        if self.k == u_bits:
            only_k_upper = (1 << u_bits) - 1
        else:
            only_k_upper = (1 << self.k) - 1
        self.only_k_upper = only_k_upper
        self.only_k_lower = diff - only_k_upper if diff >= only_k_upper else 0
        if self.k == u_bits:
            self.most_significant = 0
            self.min_unambiguous = 0
        else:
            self.most_significant = 1 << self.k
            self.min_unambiguous = (diff + 1) - self.most_significant

    def contains(self, u):
        return self.lower_u <= u <= self.upper_u


def _gcd_bits_required(rng):
    return int(math.ceil(math.log2(float(rng)))) if rng > 1 else 0


def _read_gcd(rng, r: Reader):
    if r.read_one():
        g1 = r.read_bits(_gcd_bits_required(rng))
        if g1 >= rng:
            raise _corrupt("stored GCD greater than range")
        return g1 + 1
    return 1


def _write_gcd(rng, gcd, w: Writer):
    nontrivial = gcd != 1
    w.write_one(nontrivial)
    if nontrivial:
        w.write_bits(gcd - 1, _gcd_bits_required(rng))


def _parse_prefixes(r: Reader, flags: Flags, n, dtype: QcoType, order,
                    raw_bits, u_bits):
    n_pref = r.read_bits(BITS_N_PREFIXES)
    bits_code_len = flags.bits_to_encode_code_len()
    bits_count = flags.bits_to_encode_count(n)
    u_max = (1 << u_bits) - 1
    common_gcd = None
    if flags.use_gcds:
        if r.read_one():
            common_gcd = _read_gcd(u_max, r)
    else:
        common_gcd = 1
    prefixes = []
    for _ in range(n_pref):
        count = r.read_bits(bits_count)
        lower_raw = r.read_bits(raw_bits)
        upper_raw = r.read_bits(raw_bits)
        code_len = r.read_bits(bits_code_len)
        code = tuple((r.read_bits(1)) for _ in range(code_len))
        jumpstart = r.read_bits(BITS_JUMPSTART) if r.read_one() else None
        lo_u = _prefix_raw_to_u(dtype, order, lower_raw, raw_bits)
        hi_u = _prefix_raw_to_u(dtype, order, upper_raw, raw_bits)
        if lo_u > hi_u:
            raise _corrupt("prefix lower bound above upper bound")
        gcd = common_gcd if common_gcd is not None else _read_gcd(
            hi_u - lo_u, r)
        prefixes.append(Prefix(count, code, lo_u, hi_u, jumpstart, gcd,
                               u_bits))
    return prefixes


def _write_prefixes(prefixes, w: Writer, flags: Flags, n, dtype, order,
                    raw_bits, u_bits):
    w.write_bits(len(prefixes), BITS_N_PREFIXES)
    bits_code_len = flags.bits_to_encode_code_len()
    bits_count = flags.bits_to_encode_count(n)
    common_gcd = None
    if flags.use_gcds:
        common_gcd = _common_gcd_for_meta(prefixes)
        w.write_one(common_gcd is not None)
        if common_gcd is not None:
            _write_gcd((1 << u_bits) - 1, common_gcd, w)
    else:
        common_gcd = 1
    for p in prefixes:
        w.write_bits(p.count, bits_count)
        w.write_bits(_prefix_u_to_raw(dtype, order, p.lower_u, raw_bits),
                     raw_bits)
        w.write_bits(_prefix_u_to_raw(dtype, order, p.upper_u, raw_bits),
                     raw_bits)
        w.write_bits(len(p.code), bits_code_len)
        for b in p.code:
            w.write_bits(b, 1)
        if p.jumpstart is None:
            w.write_one(False)
        else:
            w.write_one(True)
            w.write_bits(p.jumpstart, BITS_JUMPSTART)
        if common_gcd is None:
            _write_gcd(p.upper_u - p.lower_u, p.gcd, w)


def _common_gcd_for_meta(prefixes):
    """Some(gcd) iff one shared GCD is more concise (gcd_utils.rs)."""
    share = True
    gcd = None
    for p in prefixes:
        if p.upper_u != p.lower_u:
            if gcd is None:
                gcd = p.gcd
            elif gcd != p.gcd:
                share = False
    if not prefixes or not share:
        return None
    return gcd if gcd is not None else 1


# prefix raw bounds are in the SIGNED space when delta order > 0; widths:
def _prefix_spaces(dtype: QcoType, order):
    if order == 0:
        return dtype.raw_bits, dtype.u_bits
    return dtype.signed_raw_bits, dtype.u_bits


def _prefix_raw_to_u(dtype: QcoType, order, raw, raw_bits):
    """Prefix bound wire encoding -> order-preserving unsigned. Bounds are
    numbers of the chunk's latent type: the number type itself (order 0) or
    its Signed delta type (chunk_metadata.rs PrefixMetadata)."""
    if order == 0:
        return dtype.to_u(dtype.raw_to_num(raw))
    if dtype.kind == "bool":
        return 1 if raw else 0
    s = raw - (1 << raw_bits) if raw >= (1 << (raw_bits - 1)) else raw
    return dtype.s_to_u(s)


def _prefix_u_to_raw(dtype: QcoType, order, u, raw_bits):
    if order == 0:
        return dtype.num_to_raw(dtype.from_u(u))
    if dtype.kind == "bool":
        return 1 if u else 0
    return dtype.u_to_s(u) & ((1 << raw_bits) - 1)


# ---------------------------------------------------------------------------
# body decode (num_decompressor.rs, run_len_utils.rs)
# ---------------------------------------------------------------------------

def _decode_unsigneds(r: Reader, prefixes, n):
    if n == 0:
        return []
    if not prefixes:
        raise _corrupt("no prefixes for nonempty chunk body")
    max_depth = max(len(p.code) for p in prefixes)
    if max_depth > 24:
        # the encoder's Huffman codes top out around 23 bits (flags.rs);
        # refuse rather than allocate a 2^depth flat table for a crafted file
        raise _corrupt(f"prefix code too deep ({max_depth} bits)")
    # flat lookup over max_depth peeked bits; the code set must tile the
    # tree exactly (num_decompressor.rs validate_prefix_tree)
    table: List[Optional[Prefix]] = [None] * (1 << max_depth)
    for p in prefixes:
        base = 0
        for b in p.code:
            base = (base << 1) | b
        base <<= max_depth - len(p.code)
        for i in range(1 << (max_depth - len(p.code))):
            if table[base + i] is not None:
                raise _corrupt("multiple prefixes for one code")
            table[base + i] = p
    if any(e is None for e in table):
        raise _corrupt("incomplete prefix code tree")

    # native fast path (values fit u64; widths > 64 stay pure Python)
    if all(p.upper_u < (1 << 64) for p in prefixes) and n < (1 << 62):
        try:
            from pcodec_tpu_torch.native import kernels as _nk
        except ImportError:
            _nk = None
        if _nk is not None:
            pidx = {id(p): i for i, p in enumerate(prefixes)}
            tbl = np.array([pidx[id(e)] for e in table], dtype=np.int32)
            out_arr, new_pos = _nk.qco_decode_body(
                r._padded, r.total_bits, r.pos, n, max_depth, tbl,
                np.array([len(p.code) for p in prefixes], np.int32),
                np.array([p.lower_u for p in prefixes], np.uint64),
                np.array([p.gcd for p in prefixes], np.uint64),
                np.array([p.k for p in prefixes], np.int32),
                np.array([min(p.min_unambiguous, (1 << 64) - 1)
                          for p in prefixes], np.uint64),
                np.array([p.most_significant & ((1 << 64) - 1)
                          for p in prefixes], np.uint64),
                np.array([-1 if p.jumpstart is None else p.jumpstart
                          for p in prefixes], np.int32),
            )
            if new_pos < 0:
                raise InsufficientDataError("qco: out of data")
            r.pos = new_pos
            return out_arr

    out = []
    read_bits = r.read_bits
    while len(out) < n:
        p = table[r.peek_padded(max_depth)]
        depth = len(p.code)
        if r.pos + depth > r.total_bits:
            raise InsufficientDataError("qco: out of data in code")
        r.pos += depth
        if p.jumpstart is None:
            reps = 1
        else:
            # the reference caps reps at the remaining batch and leaves the
            # excess unread (num_decompressor.rs limit_reps)
            reps = min(r.read_varint(p.jumpstart) + 1, n - len(out))
        k, lower_u, gcd = p.k, p.lower_u, p.gcd
        if p.jumpstart is not None and k == 0:
            out.extend([lower_u] * reps)
            continue
        min_unamb, most_sig = p.min_unambiguous, p.most_significant
        for _ in range(reps):
            off = read_bits(k)
            if off < min_unamb and read_bits(1):
                off |= most_sig
            out.append(lower_u + off * gcd)
    return out


def _reconstruct_from_deltas(dtype: QcoType, moments, u_deltas, n):
    """delta_encoding.rs reconstruct_nums as cascaded wrapping cumsums."""
    if n == 0:
        return []
    if dtype.kind == "bool":
        vals = [1 if u else 0 for u in u_deltas]
        vals += [0] * (n - len(vals))
        for m in reversed(moments):
            vals = list(accumulate([1 if m else 0] + vals,
                                   lambda a, b: a ^ b))[:n]
        return vals
    b = dtype.u_bits
    mask = (1 << b) - 1
    half = 1 << (b - 1)
    vals = [dtype.u_to_s(u) for u in u_deltas]
    vals += [0] * max(0, n - len(vals))
    for m in reversed(moments):
        vals = list(accumulate(
            [m] + vals,
            lambda a, d: ((a + d + half) & mask) - half))[:n]
    return vals  # signed-space numbers; caller applies from_s


# ---------------------------------------------------------------------------
# compressor internals (base_compressor.rs, prefix_optimization.rs,
# huffman_encoding.rs)
# ---------------------------------------------------------------------------

def _run_len_jumpstart(count, n):
    freq = count / n
    if n >= MIN_N_RUN_LEN and freq >= MIN_FREQ_RUN_LEN and count < n:
        return min(int(math.ceil(-math.log2(1.0 - freq))), MAX_JUMPSTART)
    return None


def _weight_and_jumpstart_cost(count, n):
    freq = count / n
    if n >= MIN_N_RUN_LEN and freq >= MIN_FREQ_RUN_LEN and count < n:
        non_freq = 1.0 - freq
        weight = int(math.ceil(freq * non_freq * n))
        return weight, math.ceil(-math.log2(non_freq)) + 1.0
    return count, 0.0


def _bumpy_log(x):
    k = int(math.floor(math.log2(x)))
    return (k + 2) - (2.0 ** (k + 1)) / x


def _avg_offset_bits(lower_u, upper_u, gcd):
    return _bumpy_log(float((upper_u - lower_u) // gcd) + 1.0)


def _choose_max_n_prefixes(level, n):
    log_n = int(math.floor(math.log2(n)))
    fast = max(log_n - 4, 0)
    real = level if level <= fast else fast + (level - fast) // 2
    return min(1 << real, n)


def _gcd_list(sorted_u):
    g = 0
    lo = sorted_u[0]
    if sorted_u[-1] == lo:
        return 1
    g = sorted_u[-1] - lo
    for x in sorted_u[1:]:
        if g == 1:
            break
        g = math.gcd(x - lo, g)
    return g


def _choose_unoptimized(sorted_u, level, use_gcds, u_bits):
    n = len(sorted_u)
    max_n_pref = _choose_max_n_prefixes(level, n)
    seq = []
    prefix_idx = 0
    target_j = ((prefix_idx + 1) * n) // max_n_pref

    def push(i, j):
        nonlocal prefix_idx, target_j
        gcd = _gcd_list(sorted_u[i:j]) if use_gcds else 1
        seq.append(Prefix(j - i, (), sorted_u[i], sorted_u[j - 1], None,
                          gcd, u_bits))
        prefix_idx = max(prefix_idx + 1, (j * max_n_pref) // n)
        target_j = ((prefix_idx + 1) * n) // max_n_pref

    i = 0
    backup_j = 0
    for j in range(1, n):
        if sorted_u[j] == sorted_u[j - 1]:
            if j >= target_j and j - target_j >= target_j - backup_j \
                    and backup_j > i:
                push(i, backup_j)
                i = backup_j
        else:
            backup_j = j
            if j >= target_j:
                push(i, j)
                i = j
    push(i, n)
    return seq


def _fold_gcds_left(left_lower, left_upper, left_gcd, right_upper, acc):
    if left_upper != right_upper:
        d = right_upper - left_upper
        acc = d if acc is None else math.gcd(d, acc)
    if left_upper != left_lower:
        acc = left_gcd if acc is None else math.gcd(left_gcd, acc)
    return acc


def _optimize_prefixes(prefixes, flags: Flags, n, raw_bits, u_bits):
    """Exactly-optimal adjacent-merge DP (prefix_optimization.rs)."""
    B = len(prefixes)
    cum = [0]
    for p in prefixes:
        cum.append(cum[-1] + p.count)
    lowers = [p.lower_u for p in prefixes]
    uppers = [p.upper_u for p in prefixes]
    gcds = [p.gcd for p in prefixes]

    base_meta_cost = (flags.bits_to_encode_count(n) + 2.0 * raw_bits
                      + flags.bits_to_encode_code_len()
                      + (1.0 if flags.use_gcds else 0.0) + 1.0)
    fold_gcd = flags.use_gcds and (
        any(p.gcd > 1 for p in prefixes)
        or any(prefixes[i].lower_u == prefixes[i].upper_u
               and prefixes[i - 1].lower_u == prefixes[i - 1].upper_u
               and prefixes[i - 1].upper_u + 1 < prefixes[i].lower_u
               for i in range(1, B)))

    best_costs = [0.0]
    best_js = []
    for i in range(B):
        best_cost = math.inf
        best_j = -1
        upper = uppers[i]
        cci = cum[i + 1]
        acc = None
        for j in range(i, -1, -1):
            lower = lowers[j]
            if fold_gcd:
                acc = _fold_gcds_left(lower, uppers[j], gcds[j], upper, acc)
            gcd = acc if acc is not None else 1
            count = cci - cum[j]
            weight, jcost = _weight_and_jumpstart_cost(count, n)
            total_weight = n + weight - count
            huff = math.log2(total_weight / weight)
            gcost = _gcd_bits_required(upper - lower) if gcd > 1 else 0.0
            cost = best_costs[j] + (
                base_meta_cost + gcost + huff + (huff + jcost) * weight
                + _avg_offset_bits(lower, upper, gcd) * count)
            if cost < best_cost:
                best_cost = cost
                best_j = j
        best_costs.append(best_cost)
        best_js.append(best_j)

    path = []
    i = B - 1
    while i >= 0:
        j = best_js[i]
        path.append((j, i))
        i = j - 1
    path.reverse()

    res = []
    for j, i in path:
        count = 0
        acc = None
        for k2 in range(i, j - 1, -1):
            count += prefixes[k2].count
            if fold_gcd:
                acc = _fold_gcds_left(lowers[k2], uppers[k2], gcds[k2],
                                      uppers[i], acc)
        res.append(Prefix(count, (), lowers[j], uppers[i],
                          _run_len_jumpstart(count, n),
                          acc if acc is not None else 1, u_bits))
    return res


def _make_huffman_codes(prefixes, n):
    if len(prefixes) == 1:
        prefixes[0].code = ()
        return
    heap = []
    for i, p in enumerate(prefixes):
        weight, _ = _weight_and_jumpstart_cost(p.count, n)
        heapq.heappush(heap, (weight, i, ("leaf", i)))
    nid = len(prefixes)
    while len(heap) > 1:
        w0, _, t0 = heapq.heappop(heap)
        w1, _, t1 = heapq.heappop(heap)
        heapq.heappush(heap, (w0 + w1, nid, ("node", t0, t1)))
        nid += 1
    _, _, root = heap[0]

    def assign(node, bits):
        if node[0] == "leaf":
            prefixes[node[1]].code = tuple(bits)
        else:
            assign(node[1], bits + [0])
            assign(node[2], bits + [1])

    assign(root, [])
    # rebuild derived fields unaffected; code only used for write/search


def _train_prefixes(unsigneds, level, flags: Flags, n, raw_bits, u_bits):
    if len(unsigneds) == 0:
        return []
    if level > MAX_LEVEL:
        raise InvalidArgumentError("qco: compression level too high")
    if n > MAX_ENTRIES:
        raise InvalidArgumentError("qco: too many entries per chunk")
    if isinstance(unsigneds, np.ndarray):
        sorted_u = np.sort(unsigneds).tolist()
    else:
        sorted_u = sorted(unsigneds)
    prefs = _choose_unoptimized(sorted_u, level, flags.use_gcds, u_bits)
    prefs = _optimize_prefixes(prefs, flags, n, raw_bits, u_bits)
    _make_huffman_codes(prefs, n)
    return prefs


def _compress_body(prefixes, unsigneds, w: Writer):
    """base_compressor.rs compress_data_page."""
    if (isinstance(unsigneds, np.ndarray) and len(prefixes)
            and all(p.upper_u < (1 << 64) for p in prefixes)):
        try:
            from pcodec_tpu_torch.native import kernels as _nk
        except ImportError:
            _nk = None
        if _nk is not None and w.nbits == 0:
            ps = sorted(prefixes, key=lambda p: p.lower_u)
            max_cl = max(len(p.code) for p in ps)
            max_k = max(p.k for p in ps)
            cap_bits = len(unsigneds) * (max_cl + max_k + 52) + 128
            dst = np.zeros(cap_bits // 8 + 16, dtype=np.uint8)
            codes = np.array(
                [sum(bit << (len(p.code) - 1 - i)
                     for i, bit in enumerate(p.code)) for p in ps],
                np.uint32)
            nbits = _nk.qco_encode_body(
                np.ascontiguousarray(unsigneds, np.uint64),
                np.array([p.lower_u for p in ps], np.uint64),
                np.array([p.upper_u for p in ps], np.uint64),
                np.array([p.gcd for p in ps], np.uint64),
                codes,
                np.array([len(p.code) for p in ps], np.int32),
                np.array([p.k for p in ps], np.int32),
                np.array([p.only_k_lower for p in ps], np.uint64),
                np.array([p.only_k_upper for p in ps], np.uint64),
                np.array([-1 if p.jumpstart is None else p.jumpstart
                          for p in ps], np.int32),
                dst,
            )
            if nbits < 0:
                raise InvalidArgumentError("qco: number not in any prefix")
            w.buf.extend(dst[: -(-nbits // 8)].tobytes())
            return
        unsigneds = [int(u) for u in unsigneds]
    elif isinstance(unsigneds, np.ndarray):
        unsigneds = [int(u) for u in unsigneds]
    # search: prefixes sorted by lower bound; ranges tile the value set
    order = sorted(range(len(prefixes)), key=lambda i: prefixes[i].lower_u)
    lowers = [prefixes[i].lower_u for i in order]
    import bisect
    n = len(unsigneds)
    i = 0
    while i < n:
        u = unsigneds[i]
        pi = bisect.bisect_right(lowers, u) - 1
        p = prefixes[order[pi]]
        if not p.contains(u):
            raise InvalidArgumentError("qco: number not in any prefix")
        code = p.code
        cv = 0
        for b in code:
            cv = (cv << 1) | b
        w.write_bits(cv, len(code))
        if p.jumpstart is None:
            _write_offset(u, p, w)
            i += 1
        else:
            reps = 1
            for j in range(i + 1, n):
                if p.contains(unsigneds[j]):
                    reps += 1
                else:
                    break
            w.write_varint(reps - 1, p.jumpstart)
            for j in range(i, i + reps):
                _write_offset(unsigneds[j], p, w)
            i += reps
    w.finish_byte()


def _write_offset(u, p: Prefix, w: Writer):
    off = (u - p.lower_u) // p.gcd
    w.write_bits(off, p.k)
    if off < p.only_k_lower or off > p.only_k_upper:
        w.write_one((off >> p.k) & 1 > 0)


def _nth_order_deltas(dtype: QcoType, nums, order, page_idxs):
    """Signed-space wrapping diffs + per-page moments (delta_encoding.rs)."""
    if dtype.kind == "bool":
        res = [1 if x else 0 for x in nums]
        momentss = [[] for _ in page_idxs]
        for _ in range(order):
            for pi, idx in enumerate(page_idxs):
                momentss[pi].append(res[idx] if idx < len(res) else 0)
            res = [res[i] ^ res[i + 1] for i in range(len(res) - 1)]
        return res, momentss
    b = dtype.u_bits
    mask = (1 << b) - 1
    half = 1 << (b - 1)
    res = [dtype.to_s(x) for x in nums]
    momentss = [[] for _ in page_idxs]
    for _ in range(order):
        for pi, idx in enumerate(page_idxs):
            momentss[pi].append(res[idx] if idx < len(res) else 0)
        res = [(((res[i + 1] - res[i]) + half) & mask) - half
               for i in range(len(res) - 1)]
    return res, momentss


# ---------------------------------------------------------------------------
# standalone format (standalone/compressor.rs, standalone/decompressor.rs)
# ---------------------------------------------------------------------------

def _nums_from_numpy(nums, dtype_name=None):
    """Returns (dtype, vals): vals is a u64 PATTERN array for numpy dtypes
    (the numpy/native fast path), else a list of number representations."""
    if isinstance(nums, np.ndarray):
        if dtype_name is None:
            dtype_name = {
                "int64": "i64", "uint64": "u64", "int32": "i32",
                "uint32": "u32", "float64": "f64", "float32": "f32",
                "bool": "bool", "uint16": "u16", "int16": "i16",
            }[str(nums.dtype)]
        t = TYPES[dtype_name]
        if t.name in NP_DTYPES and t.u_bits <= 64:
            if t.kind == "bool":
                pat = nums.astype(np.uint8).astype(np.uint64)
            else:
                pat = (nums.astype(NP_DTYPES[t.name])
                       .view(_NP_SMALL_U[t.u_bits]).astype(np.uint64))
            return t, pat
        nums = nums.tolist()
    if dtype_name is None:
        raise InvalidArgumentError("qco: dtype required for lists")
    return TYPES[dtype_name], list(nums)


def _nums_to_numpy(dtype: QcoType, nums):
    np_dt = NP_DTYPES.get(dtype.name)
    if np_dt is None:
        return nums  # ts96 etc: Python ints
    if dtype.kind == "float":
        u_dt = np.uint32 if dtype.u_bits == 32 else np.uint64
        return np.array(nums, dtype=u_dt).view(np_dt)
    if dtype.kind == "bool":
        return np.array([bool(x) for x in nums], dtype=np.bool_)
    return np.array(nums, dtype=np_dt)


def _write_chunk(w: Writer, dtype: QcoType, nums, level, flags: Flags,
                 page_sizes=None):
    """One chunk; returns per-page bodies in wrapped mode."""
    n = len(nums)
    order = flags.delta_order
    page_sizes = page_sizes or [n]
    raw_bits, u_bits = _prefix_spaces(dtype, order)
    page_idxs = [0]
    for s in page_sizes[:-1]:
        page_idxs.append(page_idxs[-1] + s)
    if isinstance(nums, np.ndarray):
        # pattern-array fast path: deltas/bijections vectorized; the
        # signed-space PATTERN of any <=64-bit kind is the raw pattern
        b = dtype.u_bits
        mask = np.uint64((1 << b) - 1)
        half = np.uint64(1 << (b - 1))
        momentss = [[] for _ in page_sizes]
        with np.errstate(over="ignore"):
            if order == 0:
                if dtype.kind == "int":
                    unsigneds = (nums + half) & mask
                elif dtype.kind == "float":
                    unsigneds = np.where(
                        nums & half, (~nums) & mask, nums ^ half)
                else:  # uint / bool
                    unsigneds = nums
            else:
                res = nums
                for _ in range(order):
                    for pi, idx in enumerate(page_idxs):
                        momentss[pi].append(
                            int(res[idx]) if idx < len(res) else 0)
                    if dtype.kind == "bool":
                        res = np.bitwise_xor(res[1:], res[:-1])
                    else:
                        res = (res[1:] - res[:-1]) & mask
                if dtype.kind == "bool":
                    unsigneds = res
                else:
                    unsigneds = (res + half) & mask
    elif order == 0:
        unsigneds = [dtype.to_u(x) for x in nums]
        momentss = [[] for _ in page_sizes]
    else:
        deltas, momentss = _nth_order_deltas(dtype, nums, order, page_idxs)
        unsigneds = [dtype.s_to_u(d) for d in deltas]
    prefs = _train_prefixes(unsigneds, level, flags, n, raw_bits, u_bits)

    # metadata (preceded by the chunk magic byte in standalone mode,
    # base_compressor.rs chunk_metadata_internal)
    meta = Writer()
    if not flags.use_wrapped_mode:
        meta.write_bits(CHUNK_BYTE, 8)
        meta.write_bits(n, BITS_N_ENTRIES)
        meta.write_bits(0, BITS_BODY_SIZE)  # backfilled below
        for m in momentss[0]:
            meta.write_bits(_moment_raw(dtype, m), raw_bits)
    _write_prefixes(prefs, meta, flags, n, dtype, order, raw_bits, u_bits)
    meta.finish_byte()
    meta_bytes = bytearray(meta.to_bytes())

    # body (one per page)
    bodies = []
    start = 0
    for pi, psize in enumerate(page_sizes):
        # each page writes page_n - order deltas; the index advances by the
        # FULL page size (base_compressor.rs data_page_internal idx += n)
        end = start + max(psize - order, 0)
        body = Writer()
        if flags.use_wrapped_mode:
            for m in momentss[pi]:
                body.write_bits(_moment_raw(dtype, m), raw_bits)
        _compress_body(prefs, unsigneds[start:end], body)
        bodies.append(body.to_bytes())
        start += psize

    if not flags.use_wrapped_mode:
        cbs = len(bodies[0])
        meta_bytes[4:8] = cbs.to_bytes(4, "big")  # after chunk byte + 24-bit n
        w.buf.extend(meta_bytes)
        w.buf.extend(bodies[0])
        return None
    w.buf.extend(meta_bytes)
    return bodies


def _moment_raw(dtype: QcoType, m):
    if dtype.kind == "bool":
        return 1 if m else 0
    return m & ((1 << dtype.signed_raw_bits) - 1)


def _moment_from_raw(dtype: QcoType, r):
    b = dtype.signed_raw_bits
    if dtype.kind == "bool":
        return 1 if r else 0
    return r - (1 << b) if r >= (1 << (b - 1)) else r


def _compress_vals(dtype, vals, level, delta_order, use_gcds):
    """Standalone compress of pre-converted vals (pattern array or list)."""
    flags = Flags(delta_order=delta_order, use_gcds=use_gcds)
    w = Writer()
    w.buf.extend(MAGIC)
    w.buf.append(dtype.header_byte)
    flags.write(w)
    w.finish_byte()
    n = len(vals)
    if n:
        n_chunks = -(-n // DEFAULT_CHUNK_SIZE)
        per = -(-n // n_chunks)
        for s in range(0, n, per):
            _write_chunk(w, dtype, vals[s : s + per], level, flags)
    w.buf.append(TERM_BYTE)
    return bytes(w.buf)


def qco_compress(nums, dtype_name=None, level=DEFAULT_LEVEL, delta_order=0,
                 use_gcds=True):
    """Standalone .qco bytes (ref: standalone/compressor.rs
    simple_compress)."""
    dtype, vals = _nums_from_numpy(nums, dtype_name)
    return _compress_vals(dtype, vals, level, delta_order, use_gcds)



def _assemble(dtype: QcoType, pieces, as_numpy):
    """Concatenate per-chunk results (numpy arrays and/or lists)."""
    if dtype.name in NP_DTYPES:
        arrs = [p if isinstance(p, np.ndarray) else _nums_to_numpy(dtype, p)
                for p in pieces]
        full = (np.concatenate(arrs) if arrs
                else _nums_to_numpy(dtype, []))
        return full if as_numpy else full.tolist()
    flat = []
    for p in pieces:
        flat.extend(p.tolist() if isinstance(p, np.ndarray) else p)
    return flat


def qco_decompress(data, as_numpy=True):
    """Standalone .qco decode; returns (values, dtype name)."""
    r = Reader(data)
    if r.read_aligned_bytes(4) != MAGIC:
        raise _corrupt("bad magic header")
    hb = r.read_aligned_bytes(1)[0]
    dtype = HEADER_BYTE_TO_TYPE.get(hb)
    if dtype is None:
        raise _corrupt(f"unknown data type byte {hb}")
    flags = Flags.parse_from(r)
    if flags.use_wrapped_mode:
        raise _corrupt("wrapped-mode file passed to standalone decompressor")
    out = []
    order = flags.delta_order
    raw_bits, u_bits = _prefix_spaces(dtype, order)
    while True:
        magic = r.read_aligned_bytes(1)[0]
        if magic == TERM_BYTE:
            break
        if magic != CHUNK_BYTE:
            raise _corrupt(f"invalid magic chunk byte {magic}")
        n = r.read_bits(BITS_N_ENTRIES)
        cbs = r.read_bits(BITS_BODY_SIZE)
        moments = [_moment_from_raw(dtype, r.read_bits(raw_bits))
                   for _ in range(order)]
        prefs = _parse_prefixes(r, flags, n, dtype, order, raw_bits, u_bits)
        r.drain_empty_byte("nonzero bits at end of chunk metadata")
        body_start = r.aligned_byte_idx()
        us = _decode_unsigneds(r, prefs, max(n - order, 0) if order else n)
        r.pos = (body_start + cbs) * 8
        if r.pos > r.total_bits:
            raise InsufficientDataError("qco: body overruns file")
        out.append(_join_chunk(dtype, order, moments, us, n))
    return _assemble(dtype, out, as_numpy), dtype.name


_NP_SMALL_U = {8: np.uint8, 16: np.uint16, 32: np.uint32, 64: np.uint64}
_NP_SMALL_I = {8: np.int8, 16: np.int16, 32: np.int32, 64: np.int64}


def _patterns_to_np(dtype: QcoType, pat: np.ndarray):
    """u_bits-bit patterns (u64 array) -> final numpy values."""
    b = dtype.u_bits
    small = pat if b == 64 else pat.astype(_NP_SMALL_U[b])
    if dtype.kind == "int":
        return small.view(_NP_SMALL_I[b])
    if dtype.kind == "float":
        return small.view(NP_DTYPES[dtype.name])
    if dtype.kind == "bool":
        return small != 0
    return small  # uint


def _join_chunk_np(dtype: QcoType, order, moments, us: np.ndarray, n):
    """Vectorized _join_chunk for <= 64-bit dtypes (native decode path)."""
    b = dtype.u_bits
    mask = np.uint64((1 << b) - 1)
    half = np.uint64(1 << (b - 1))
    if order == 0:
        u = us & mask
        if dtype.kind in ("int",):
            pat = (u + half) & mask  # from_u = u - MID, same bit pattern
        elif dtype.kind == "float":
            sign = half
            pat = np.where(u & sign, u ^ sign, (~u) & mask)
        else:  # uint / bool
            pat = u
        return _patterns_to_np(dtype, pat)
    if dtype.kind == "bool":
        vals = (us != 0).astype(np.uint8)
        vals = np.concatenate(
            [vals, np.zeros(max(0, n - len(vals)), np.uint8)])
        for m in reversed(moments):
            seq = np.concatenate(
                [np.array([1 if m else 0], np.uint8), vals])
            vals = np.bitwise_xor.accumulate(seq)[:n]
        return vals != 0
    # wrapping cumsum cascade on u_bits-bit patterns (u64 wraps; mask = mod)
    with np.errstate(over="ignore"):
        vals = ((us & mask) + half) & mask  # u_to_s patterns
        vals = np.concatenate(
            [vals, np.zeros(max(0, n - len(vals)), np.uint64)])
        for m in reversed(moments):
            seq = np.concatenate(
                [np.array([m & ((1 << b) - 1)], np.uint64), vals])
            vals = np.cumsum(seq, dtype=np.uint64)[:n] & mask
    return _patterns_to_np(dtype, vals)


def _join_chunk(dtype: QcoType, order, moments, us, n):
    if isinstance(us, np.ndarray) and dtype.name in NP_DTYPES:
        return _join_chunk_np(dtype, order, moments, us, n)
    us = list(us)
    if order == 0:
        return [dtype.from_u(int(u)) for u in us]
    signed = _reconstruct_from_deltas(dtype, moments, us, n)
    if dtype.kind == "bool":
        return signed
    return [dtype.from_s(s) for s in signed]


def auto_compress(nums, dtype_name=None, level=DEFAULT_LEVEL):
    """auto.rs: sample head (and tail if the head is constant), try delta
    orders 0..7 at a capped level with GCDs off, keep the smallest."""
    dtype, vals = _nums_from_numpy(nums, dtype_name)
    n = len(vals)
    if n < AUTO_DELTA_LIMIT:
        head = vals
    else:
        half = AUTO_DELTA_LIMIT // 2
        head = vals[:half]
        if all(x == head[0] for x in head):
            if isinstance(vals, np.ndarray):
                head = np.concatenate([head, vals[-half:]])
            else:
                head = head + vals[-half:]
        else:
            head = vals[:AUTO_DELTA_LIMIT]
    best_order, best_size = 0, None
    for order in range(8):
        if len(head):
            trial = _compress_vals(
                dtype, head, min(level, MAX_AUTO_DELTA_LEVEL), order,
                use_gcds=False)
            size = len(trial)
        else:
            size = 0
        if best_size is None or size < best_size:
            best_order, best_size = order, size
    return _compress_vals(dtype, vals, level, best_order, use_gcds=True)


def auto_decompress(data, as_numpy=True):
    return qco_decompress(data, as_numpy=as_numpy)


# ---------------------------------------------------------------------------
# wrapped mode (flags.use_wrapped_mode; outer framing matches the
# reference's test harness: q_compress/src/tests/utils.rs)
# ---------------------------------------------------------------------------

def wrapped_compress(nums, dtype_name=None, level=DEFAULT_LEVEL,
                     delta_order=0, use_gcds=True, sizess=None):
    dtype, vals = _nums_from_numpy(nums, dtype_name)
    flags = Flags(delta_order=delta_order, use_gcds=use_gcds,
                  use_wrapped_mode=True)
    hw = Writer()
    hw.buf.extend(MAGIC)
    hw.buf.append(dtype.header_byte)
    flags.write(hw)
    hw.finish_byte()
    header = hw.to_bytes()
    sizess = sizess or [[len(vals)]]

    out = bytearray()
    out += len(header).to_bytes(4, "big")
    out += len(sizess).to_bytes(4, "big")
    out += header
    start = 0
    for sizes in sizess:
        cn = sum(sizes)
        chunk_nums = vals[start : start + cn]
        start += cn
        cw = Writer()
        bodies = _write_chunk(cw, dtype, chunk_nums, level, flags,
                              page_sizes=sizes)
        meta = cw.to_bytes()
        out += len(meta).to_bytes(4, "big")
        out += len(sizes).to_bytes(4, "big")
        out += meta
        for body, size in zip(bodies, sizes):
            out += len(body).to_bytes(4, "big")
            out += size.to_bytes(4, "big")
            out += body
    return bytes(out)


def wrapped_decompress(data, as_numpy=True):
    """Decode the reference test harness's wrapped framing
    (tests/utils.rs wrapped_decompress)."""
    pos = 0

    def u32():
        nonlocal pos
        v = int.from_bytes(data[pos : pos + 4], "big")
        pos += 4
        return v

    header_len = u32()
    n_chunks = u32()
    hr = Reader(data[pos : pos + header_len])
    pos += header_len
    if hr.read_aligned_bytes(4) != MAGIC:
        raise _corrupt("bad magic header")
    hb = hr.read_aligned_bytes(1)[0]
    dtype = HEADER_BYTE_TO_TYPE.get(hb)
    if dtype is None:
        raise _corrupt(f"unknown data type byte {hb}")
    flags = Flags.parse_from(hr)
    if not flags.use_wrapped_mode:
        raise _corrupt("standalone file passed to wrapped decompressor")
    order = flags.delta_order
    raw_bits, u_bits = _prefix_spaces(dtype, order)

    out = []
    for _ in range(n_chunks):
        meta_len = u32()
        n_pages = u32()
        mr = Reader(data[pos : pos + meta_len])
        pos += meta_len
        prefs = _parse_prefixes(mr, flags, 0, dtype, order, raw_bits, u_bits)
        mr.drain_empty_byte("nonzero bits at end of chunk metadata")
        for _ in range(n_pages):
            page_len = u32()
            size = u32()
            pr = Reader(data[pos : pos + page_len])
            pos += page_len
            moments = [_moment_from_raw(dtype, pr.read_bits(raw_bits))
                       for _ in range(order)]
            us = _decode_unsigneds(
                pr, prefs, max(size - order, 0) if order else size)
            out.append(_join_chunk(dtype, order, moments, us, size))
    return _assemble(dtype, out, as_numpy), dtype.name


def read_raw_asset(data: bytes, dtype_name: str):
    """Parse a q_compress .bin asset (big-endian raw values)."""
    t = TYPES[dtype_name]
    nbytes = t.raw_bits // 8
    vals = []
    for i in range(0, len(data), nbytes):
        r = int.from_bytes(data[i : i + nbytes], "big")
        vals.append(t.raw_to_num(r))
    return _nums_to_numpy(t, vals)
