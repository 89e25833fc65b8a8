"""Wire-format metadata: header, chunk meta, page meta.

Exact implementation of the Pco format spec (docs/format.md). File references
point at the reference implementation for parity checking:
  - FormatVersion: pco/src/metadata/format_version.rs:24-100
  - Mode wire:     pco/src/metadata/mode.rs:102-229
  - DeltaEncoding: pco/src/metadata/delta_encoding.rs:129-298
  - Bins:          pco/src/metadata/chunk_latent_var.rs:21-188, bin.rs:9-38
  - ChunkMeta:     pco/src/metadata/chunk.rs:20-189
  - PageMeta:      pco/src/metadata/page.rs:21-58, page_latent_var.rs:18-50
"""

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from pcodec_tpu_torch import constants as c
from pcodec_tpu_torch.dtypes import U32, LatentType
from pcodec_tpu_torch.errors import CorruptionError
from pcodec_tpu_torch.format.bitio import BitReader, BitWriter

# ---------------------------------------------------------------------------
# format version
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FormatVersion:
    major: int = c.CURRENT_FORMAT_VERSION[0]
    minor: int = c.CURRENT_FORMAT_VERSION[1]

    @classmethod
    def read_from(cls, reader: BitReader) -> "FormatVersion":
        major = reader.read_aligned_bytes(1)[0]
        minor = reader.read_aligned_bytes(1)[0] if major >= 4 else 0
        fv = cls(major, minor)
        max_major, _ = c.MAX_SUPPORTED_FORMAT_VERSION
        if major > max_major:
            raise CorruptionError(
                f"file format version {major}.{minor} cannot be decompressed; "
                f"max supported major is {max_major}"
            )
        return fv

    def write_to(self, writer: BitWriter) -> None:
        # Mirrors read_from: pre-v4 headers carry no minor byte. The
        # compressor always writes the current version; older versions only
        # occur when re-serializing parsed files.
        if self.major >= 4:
            writer.write_aligned_bytes(bytes([self.major, self.minor]))
        else:
            writer.write_aligned_bytes(bytes([self.major]))

    def used_old_gcds(self) -> bool:
        return self.major == 0

    def supports_delta_variants(self) -> bool:
        return self.major >= 3


# ---------------------------------------------------------------------------
# per-latent-var container (file order: delta, primary, secondary)
# ---------------------------------------------------------------------------

DELTA, PRIMARY, SECONDARY = "delta", "primary", "secondary"
LATENT_VAR_KEYS = (DELTA, PRIMARY, SECONDARY)


@dataclass
class PerLatentVar:
    delta: object = None
    primary: object = None
    secondary: object = None

    def enumerated(self):
        if self.delta is not None:
            yield DELTA, self.delta
        yield PRIMARY, self.primary
        if self.secondary is not None:
            yield SECONDARY, self.secondary

    def get(self, key):
        return getattr(self, key)

    def set(self, key, value):
        setattr(self, key, value)

    def map(self, fn) -> "PerLatentVar":
        return PerLatentVar(
            delta=None if self.delta is None else fn(DELTA, self.delta),
            primary=fn(PRIMARY, self.primary),
            secondary=None if self.secondary is None else fn(SECONDARY, self.secondary),
        )


# ---------------------------------------------------------------------------
# modes
# ---------------------------------------------------------------------------


@dataclass
class Mode:
    """Tagged union over the 5 modes; `payload` depends on kind.

    kind "classic": payload None
    kind "int_mult"/"float_mult": payload = base latent (python int)
    kind "float_quant": payload = k (bits)
    kind "dict": payload = np array of raw latent values
    """

    kind: str
    payload: object = None

    CLASSIC, INT_MULT, FLOAT_MULT, FLOAT_QUANT, DICT = (
        "classic", "int_mult", "float_mult", "float_quant", "dict",
    )
    _WIRE = {CLASSIC: 0, INT_MULT: 1, FLOAT_MULT: 2, FLOAT_QUANT: 3, DICT: 4}

    @classmethod
    def read_from(cls, reader: BitReader, version: FormatVersion, latent_type: LatentType) -> "Mode":
        value = reader.read_uint(c.BITS_TO_ENCODE_MODE_VARIANT)
        if value == 0:
            mode = cls(cls.CLASSIC)
        elif value == 1:
            if version.used_old_gcds():
                raise CorruptionError(
                    "unable to decompress data from yanked v0.0.0 of pco with different GCD encoding"
                )
            mode = cls(cls.INT_MULT, reader.read_uint(latent_type.bits))
        elif value == 2:
            mode = cls(cls.FLOAT_MULT, reader.read_uint(latent_type.bits))
        elif value == 3:
            mode = cls(cls.FLOAT_QUANT, reader.read_uint(c.BITS_TO_ENCODE_QUANTIZE_K))
        elif value == 4:
            n_unique = reader.read_uint(c.BITS_TO_ENCODE_DICT_LEN)
            reader.drain_empty_byte("expected zeros between dict mode length and values")
            reader.check_in_bounds()
            dict_vals = np.zeros(n_unique, dtype=latent_type.np_dtype)
            for i in range(n_unique):
                dict_vals[i] = reader.read_uint(latent_type.bits)
            reader.check_in_bounds()
            mode = cls(cls.DICT, dict_vals)
        else:
            raise CorruptionError(f"unknown mode variant {value}")
        reader.check_in_bounds()
        return mode

    def write_to(self, writer: BitWriter, latent_type: LatentType) -> None:
        writer.write_uint(self._WIRE[self.kind], c.BITS_TO_ENCODE_MODE_VARIANT)
        if self.kind in (self.INT_MULT, self.FLOAT_MULT):
            writer.write_uint(int(self.payload), latent_type.bits)
        elif self.kind == self.FLOAT_QUANT:
            writer.write_uint(int(self.payload), c.BITS_TO_ENCODE_QUANTIZE_K)
        elif self.kind == self.DICT:
            writer.write_uint(len(self.payload), c.BITS_TO_ENCODE_DICT_LEN)
            writer.finish_byte()
            # the entries in one batch write, the bits of one write_uint each
            writer.write_batch(np.asarray(self.payload, np.uint64), np.full(len(self.payload), latent_type.bits))

    def primary_latent_type(self, number_latent_type: LatentType) -> LatentType:
        return U32 if self.kind == self.DICT else number_latent_type

    def secondary_latent_type(self, number_latent_type: LatentType) -> Optional[LatentType]:
        if self.kind in (self.INT_MULT, self.FLOAT_MULT, self.FLOAT_QUANT):
            return number_latent_type
        return None


# ---------------------------------------------------------------------------
# delta encodings
# ---------------------------------------------------------------------------


@dataclass
class DeltaEncoding:
    """Tagged union: noop | consecutive | lookback | conv1."""

    kind: str
    order: int = 0  # consecutive order / conv1 n_weights
    secondary_uses_delta: bool = False
    window_n_log: int = 0  # lookback
    state_n_log: int = 0  # lookback
    quantization: int = 0  # conv1
    bias: int = 0  # conv1, signed python int
    weights: tuple = ()  # conv1, signed python ints

    NOOP, CONSECUTIVE, LOOKBACK, CONV1 = "noop", "consecutive", "lookback", "conv1"

    @property
    def window_n(self) -> int:
        return 1 << self.window_n_log

    @property
    def state_n(self) -> int:
        return 1 << self.state_n_log

    @classmethod
    def noop(cls):
        return cls(cls.NOOP)

    @classmethod
    def consecutive(cls, order: int, secondary_uses_delta: bool = False):
        return cls(cls.CONSECUTIVE, order=order, secondary_uses_delta=secondary_uses_delta)

    @classmethod
    def lookback(cls, window_n_log: int, state_n_log: int, secondary_uses_delta: bool = False):
        return cls(
            cls.LOOKBACK,
            window_n_log=window_n_log,
            state_n_log=state_n_log,
            secondary_uses_delta=secondary_uses_delta,
        )

    @classmethod
    def conv1(cls, quantization: int, bias: int, weights):
        return cls(cls.CONV1, order=len(weights), quantization=quantization,
                   bias=bias, weights=tuple(weights))

    @classmethod
    def read_from(cls, reader: BitReader, version: FormatVersion) -> "DeltaEncoding":
        if not version.supports_delta_variants():
            order = reader.read_uint(c.BITS_TO_ENCODE_DELTA_ENCODING_ORDER)
            return cls.noop() if order == 0 else cls.consecutive(order)

        variant = reader.read_uint(c.BITS_TO_ENCODE_DELTA_ENCODING_VARIANT)
        if variant == 0:
            return cls.noop()
        if variant == 1:
            order = reader.read_uint(c.BITS_TO_ENCODE_DELTA_ENCODING_ORDER)
            if order == 0:
                raise CorruptionError("Consecutive delta encoding order must not be 0")
            return cls.consecutive(order, reader.read_bool())
        if variant == 2:
            window_n_log = 1 + reader.read_uint(c.BITS_TO_ENCODE_DELTA_LOOKBACK_WINDOW_N_LOG)
            state_n_log = reader.read_uint(c.BITS_TO_ENCODE_DELTA_LOOKBACK_STATE_N_LOG)
            if state_n_log > window_n_log:
                raise CorruptionError(
                    f"LZ delta encoding state size log exceeded window size log: "
                    f"{state_n_log} vs {window_n_log}"
                )
            return cls.lookback(window_n_log, state_n_log, reader.read_bool())
        if variant == 3:
            quantization = reader.read_uint(c.BITS_TO_ENCODE_DELTA_CONV_QUANTIZATION)
            bias_u = reader.read_uint(64)
            bias = bias_u - (1 << 63)  # i64::from_latent_ordered
            order = 1 + reader.read_uint(c.BITS_TO_ENCODE_DELTA_CONV_N_WEIGHTS)
            weights = []
            for _ in range(order):
                w_u = reader.read_uint(32)
                weights.append(w_u - (1 << 31))  # i32::from_latent_ordered
            return cls.conv1(quantization, bias, weights)
        raise CorruptionError(f"unknown delta encoding value: {variant}")

    def write_to(self, writer: BitWriter, version: Optional[FormatVersion] = None) -> None:
        if version is not None and not version.supports_delta_variants():
            # legacy pre-v3 wire: 3-bit consecutive order only (0 = noop)
            writer.write_uint(
                self.order if self.kind == self.CONSECUTIVE else 0,
                c.BITS_TO_ENCODE_DELTA_ENCODING_ORDER,
            )
            return
        variant = {self.NOOP: 0, self.CONSECUTIVE: 1, self.LOOKBACK: 2, self.CONV1: 3}[self.kind]
        writer.write_uint(variant, c.BITS_TO_ENCODE_DELTA_ENCODING_VARIANT)
        if self.kind == self.CONSECUTIVE:
            writer.write_uint(self.order, c.BITS_TO_ENCODE_DELTA_ENCODING_ORDER)
            writer.write_bool(self.secondary_uses_delta)
        elif self.kind == self.LOOKBACK:
            writer.write_uint(self.window_n_log - 1, c.BITS_TO_ENCODE_DELTA_LOOKBACK_WINDOW_N_LOG)
            writer.write_uint(self.state_n_log, c.BITS_TO_ENCODE_DELTA_LOOKBACK_STATE_N_LOG)
            writer.write_bool(self.secondary_uses_delta)
        elif self.kind == self.CONV1:
            writer.write_uint(self.quantization, c.BITS_TO_ENCODE_DELTA_CONV_QUANTIZATION)
            writer.write_uint(self.bias + (1 << 63), 64)
            writer.write_uint(len(self.weights) - 1, c.BITS_TO_ENCODE_DELTA_CONV_N_WEIGHTS)
            for w in self.weights:
                writer.write_uint((w & 0xFFFFFFFF) ^ (1 << 31), 32)

    def latent_type(self) -> Optional[LatentType]:
        return U32 if self.kind == self.LOOKBACK else None

    def for_latent_var(self, key: str) -> "DeltaEncoding":
        """Resolve the effective encoding for one latent var.

        ref: pco/src/metadata/delta_encoding.rs:255-298 — delta vars are never
        delta encoded; secondary only if the flag is set (never for conv1).
        """
        if self.kind == self.NOOP or key == DELTA:
            return DeltaEncoding.noop()
        if key == PRIMARY:
            return self
        # secondary
        if self.kind in (self.CONSECUTIVE, self.LOOKBACK) and self.secondary_uses_delta:
            return self
        return DeltaEncoding.noop()

    def n_latents_per_state(self) -> int:
        if self.kind == self.NOOP:
            return 0
        if self.kind == self.CONSECUTIVE:
            return self.order
        if self.kind == self.LOOKBACK:
            return 1 << self.state_n_log
        return len(self.weights)


# ---------------------------------------------------------------------------
# bins / chunk latent var meta
# ---------------------------------------------------------------------------


@dataclass
class Bins:
    """Columnar bins: weights, lowers, offset_bits as numpy arrays."""

    latent_type: LatentType
    weights: np.ndarray  # uint32
    lowers: np.ndarray  # latent dtype
    offset_bits: np.ndarray  # uint32

    def __len__(self) -> int:
        return len(self.weights)

    @classmethod
    def empty(cls, latent_type: LatentType) -> "Bins":
        return cls(
            latent_type,
            np.zeros(0, dtype=np.uint32),
            np.zeros(0, dtype=latent_type.np_dtype),
            np.zeros(0, dtype=np.uint32),
        )

    def are_trivial(self) -> bool:
        return len(self) == 0 or (len(self) == 1 and self.offset_bits[0] == 0)

    def max_offset_bits(self) -> int:
        return int(self.offset_bits.max(initial=0))

    def avg_bits_per_latent(self, ans_size_log: int) -> float:
        total_weight = float(1 << ans_size_log)
        w = self.weights.astype(np.float64)
        ans_bits = ans_size_log - np.log2(w)
        return float(np.sum((ans_bits + self.offset_bits) * w / total_weight))

    def worst_case_bits_per_latent(self, ans_size_log: int) -> np.ndarray:
        ilog2_w = np.frompyfunc(lambda x: int(x).bit_length() - 1, 1, 1)(self.weights).astype(np.int64)
        return self.offset_bits.astype(np.int64) + ans_size_log - ilog2_w


def bin_exact_bit_size(latent_type: LatentType, ans_size_log: int) -> int:
    return ans_size_log + latent_type.bits + latent_type.offset_bits_bits


@dataclass
class ChunkLatentVarMeta:
    ans_size_log: int
    bins: Bins

    @property
    def latent_type(self) -> LatentType:
        return self.bins.latent_type

    @classmethod
    def read_from(cls, reader: BitReader, latent_type: LatentType) -> "ChunkLatentVarMeta":
        ans_size_log = reader.read_uint(c.BITS_TO_ENCODE_ANS_SIZE_LOG)
        n_bins = reader.read_uint(c.BITS_TO_ENCODE_N_BINS)
        reader.check_in_bounds()
        if (1 << ans_size_log) < n_bins:
            raise CorruptionError(
                f"ANS size log ({ans_size_log}) is too small for number of bins ({n_bins})"
            )
        if n_bins == 1 and ans_size_log > 0:
            raise CorruptionError(
                f"Only 1 bin but ANS size log is {ans_size_log} (should be 0)"
            )
        if ans_size_log > c.MAX_ANS_BITS:
            raise CorruptionError(
                f"ANS size log ({ans_size_log}) should not be greater than {c.MAX_ANS_BITS}"
            )
        obb = latent_type.offset_bits_bits
        bin_bits = ans_size_log + latent_type.bits + obb
        base = reader.bit_idx
        idx = np.arange(n_bins, dtype=np.int64)
        starts = base + idx * bin_bits
        # bins are fixed-width records; read each field with one vectorized
        # gather instead of a per-bin loop
        if ans_size_log > 0:
            weights = (
                reader.gather_batch(
                    starts, np.full(n_bins, ans_size_log, dtype=np.int64), ans_size_log
                ).astype(np.uint32)
                + 1
            )
        else:
            weights = np.ones(n_bins, dtype=np.uint32)
        lowers = reader.gather_batch(
            starts + ans_size_log,
            np.full(n_bins, latent_type.bits, dtype=np.int64),
            latent_type.bits,
        ).astype(latent_type.np_dtype)
        offset_bits = reader.gather_batch(
            starts + ans_size_log + latent_type.bits,
            np.full(n_bins, obb, dtype=np.int64),
            obb,
        ).astype(np.uint32)
        reader.bit_idx = base + n_bins * bin_bits
        reader.check_in_bounds()
        if n_bins and int(offset_bits.max()) > latent_type.bits:
            bad = int(offset_bits[offset_bits > latent_type.bits][0])
            raise CorruptionError(
                f"offset bits of {bad} exceeds type of {latent_type.bits} bits"
            )
        return cls(ans_size_log, Bins(latent_type, weights, lowers, offset_bits))

    def write_to(self, writer: BitWriter) -> None:
        writer.write_uint(self.ans_size_log, c.BITS_TO_ENCODE_ANS_SIZE_LOG)
        writer.write_uint(len(self.bins), c.BITS_TO_ENCODE_N_BINS)
        obb = self.latent_type.offset_bits_bits
        lowers = self.bins.lowers.astype(np.uint64)
        for i in range(len(self.bins)):
            writer.write_uint(int(self.bins.weights[i]) - 1, self.ans_size_log)
            writer.write_uint(int(lowers[i]), self.latent_type.bits)
            writer.write_uint(int(self.bins.offset_bits[i]), obb)

    def exact_bit_size(self) -> int:
        return (
            c.BITS_TO_ENCODE_ANS_SIZE_LOG
            + c.BITS_TO_ENCODE_N_BINS
            + len(self.bins) * bin_exact_bit_size(self.latent_type, self.ans_size_log)
        )

    def exact_page_meta_bit_size(self, delta_encoding: DeltaEncoding) -> int:
        return (
            self.ans_size_log * c.ANS_INTERLEAVING
            + self.latent_type.bits * delta_encoding.n_latents_per_state()
        )


# ---------------------------------------------------------------------------
# chunk meta
# ---------------------------------------------------------------------------

MAX_DELTA_ENCODING_BIT_SIZE = (
    c.BITS_TO_ENCODE_DELTA_ENCODING_VARIANT
    + c.BITS_TO_ENCODE_DELTA_CONV_QUANTIZATION
    + c.BITS_TO_ENCODE_DELTA_CONV_N_WEIGHTS
    + 64
    + c.MAX_CONV1_DELTA_ORDER * 32
)


@dataclass
class ChunkMeta:
    mode: Mode
    delta_encoding: DeltaEncoding
    per_latent_var: PerLatentVar  # of ChunkLatentVarMeta
    number_latent_type: LatentType = field(default=None)

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Cross-field corruption checks (ref: pco/src/metadata/chunk.rs:39-95)."""
        de = self.delta_encoding
        if de.kind == DeltaEncoding.LOOKBACK:
            lv = self.per_latent_var.delta
            assert lv is not None, "Lookback delta encoding requires a delta latent var"
            window_n = de.window_n
            lowers = lv.bins.lowers.astype(np.int64)
            bad = (lowers < 1) | (lowers > window_n)
            if bad.any():
                bad_lower = int(lv.bins.lowers[bad][0])
                raise CorruptionError(
                    f"delta lookback bin had invalid lower bound of {bad_lower} "
                    f"outside window [1, {window_n}]"
                )
        elif de.kind == DeltaEncoding.CONV1:
            primary_lt = self.per_latent_var.primary.latent_type
            if primary_lt.bits > 32:
                raise CorruptionError(
                    "Conv1 delta encodings are not supported on types larger than 32 bits"
                )
            conv_bits = primary_lt.conv_dtype.itemsize * 8
            max_quant = min(c.MAX_CONV1_DELTA_QUANTIZATION, conv_bits - 1)
            if de.quantization > max_quant:
                raise CorruptionError(
                    f"Conv1 delta encoding quantization of {de.quantization} "
                    f"exceeds max of {max_quant}"
                )
            max_pred = abs(float(de.bias)) + 2.0 ** primary_lt.bits * sum(
                abs(float(w)) for w in de.weights
            )
            if max_pred >= 2.0 ** (conv_bits - 1):
                raise CorruptionError(
                    f"Conv1 delta encoding weights and bias risk overflowing "
                    f"as high as {max_pred}"
                )

    @classmethod
    def read_from(
        cls, reader: BitReader, version: FormatVersion, latent_type: LatentType
    ) -> "ChunkMeta":
        mode = Mode.read_from(reader, version, latent_type)
        delta_encoding = DeltaEncoding.read_from(reader, version)
        reader.check_in_bounds()

        delta = None
        dlt = delta_encoding.latent_type()
        if dlt is not None:
            delta = ChunkLatentVarMeta.read_from(reader, dlt)
        primary = ChunkLatentVarMeta.read_from(reader, mode.primary_latent_type(latent_type))
        secondary = None
        slt = mode.secondary_latent_type(latent_type)
        if slt is not None:
            secondary = ChunkLatentVarMeta.read_from(reader, slt)

        reader.drain_empty_byte("nonzero bits in end of final byte of chunk metadata")
        return cls(mode, delta_encoding, PerLatentVar(delta, primary, secondary), latent_type)

    def write_to(self, writer: BitWriter, version: Optional[FormatVersion] = None) -> None:
        self.mode.write_to(writer, self.number_latent_type)
        self.delta_encoding.write_to(writer, version)
        for _, var_meta in self.per_latent_var.enumerated():
            var_meta.write_to(writer)
        writer.finish_byte()

    def max_size(self) -> int:
        """Worst-case byte size of this chunk meta (ref: chunk.rs:107-115)."""
        mode_payload = 0
        if self.mode.kind in (Mode.INT_MULT, Mode.FLOAT_MULT):
            mode_payload = self.number_latent_type.bits
        elif self.mode.kind == Mode.FLOAT_QUANT:
            mode_payload = c.BITS_TO_ENCODE_QUANTIZE_K
        elif self.mode.kind == Mode.DICT:
            mode_payload = (
                c.BITS_TO_ENCODE_DICT_LEN + 7 + len(self.mode.payload) * self.number_latent_type.bits
            )
        bits = c.BITS_TO_ENCODE_MODE_VARIANT + mode_payload + MAX_DELTA_ENCODING_BIT_SIZE
        for _, var_meta in self.per_latent_var.enumerated():
            bits += var_meta.exact_bit_size()
        return (bits + 7) // 8

    def exact_page_meta_size(self) -> int:
        bits = 0
        for key, var_meta in self.per_latent_var.enumerated():
            de = self.delta_encoding.for_latent_var(key)
            bits += var_meta.exact_page_meta_bit_size(de)
        return (bits + 7) // 8


# ---------------------------------------------------------------------------
# page meta
# ---------------------------------------------------------------------------


@dataclass
class PageLatentVarMeta:
    delta_state: np.ndarray  # latent dtype, length = n_latents_per_state
    ans_final_state_idxs: tuple  # 4 ints in [0, table_size)


@dataclass
class PageMeta:
    per_latent_var: PerLatentVar  # of PageLatentVarMeta

    @classmethod
    def read_from(cls, reader: BitReader, chunk_meta: ChunkMeta) -> "PageMeta":
        def read_var(key, var_meta):
            n_state = chunk_meta.delta_encoding.for_latent_var(key).n_latents_per_state()
            lt = var_meta.latent_type
            state = np.zeros(n_state, dtype=lt.np_dtype)
            for i in range(n_state):
                state[i] = reader.read_uint(lt.bits)
            idxs = tuple(
                reader.read_uint(var_meta.ans_size_log) for _ in range(c.ANS_INTERLEAVING)
            )
            return PageLatentVarMeta(state, idxs)

        per_var = chunk_meta.per_latent_var.map(read_var)
        reader.drain_empty_byte("non-zero bits at end of data page metadata")
        reader.check_in_bounds()
        return cls(per_var)

    def write_to(self, ans_size_logs: PerLatentVar, writer: BitWriter) -> None:
        for key, var_meta in self.per_latent_var.enumerated():
            state64 = var_meta.delta_state.astype(np.uint64)
            bits = var_meta.delta_state.dtype.itemsize * 8
            for v in state64.tolist():
                writer.write_uint(int(v), bits)
            for idx in var_meta.ans_final_state_idxs:
                writer.write_uint(int(idx), ans_size_logs.get(key))
        writer.finish_byte()
