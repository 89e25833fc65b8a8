"""pcodec_tpu_torch command line: compress / decompress / inspect / bench.

    python -m pcodec_tpu_torch compress in.npy out.pct --format pct
    python -m pcodec_tpu_torch decompress out.pct back.npy
    python -m pcodec_tpu_torch inspect out.pct [--json]
    python -m pcodec_tpu_torch bench [--input x.npy] --codecs pct,pco_tpu,zlib

The counterpart of the JAX package's `pcodec_tpu/cli.py` (its flags and
input readers), with the card as the default: `--device cuda` (the
default) runs the CUDA kernels, `--device cpu` their plain PyTorch
versions, `--host` the copied host codec (what the JAX CLI does without
`--device`). Without a CUDA device and without either flag, compress and
decompress exit non-zero; nothing falls back.

PCT containers compress through encode_container_device at the given
--page-n and --chunk-n, so their bytes equal the host container_compress's
at the same flags; standalone `.pco` files compress on the host
(simple_compress: there is no device encoder of them). Both formats
decompress on the device (decode_container_device,
decode_standalone_with_device).

`bench` prints the JAX CLI's CSV (same schema, codec names, synthetic
input and round-trip assertion): pct and pco_tpu decompress on the device
and pct compresses there (at container_compress's page_n and chunk_n, so
its size is the host's); pco_tpu compresses on the host, zlib, lzma, bz2
and qco (the copied `legacy` codec) are host codecs. A time is the median
wall seconds of --iters calls, each from a numpy array to a numpy array:
on the card it includes the host's planning, the upload and the result's
download, not the kernels alone (`chip_smoke.py` times those).
"""

import argparse
import csv
import sys
import time

import numpy as np

from pcodec_tpu_torch.codec.chunk_config import ChunkConfig, DeltaSpec, ModeSpec, PagingSpec
from pcodec_tpu_torch.codec.standalone import simple_compress, simple_decompress
from pcodec_tpu_torch.dtypes import NUMBER_TYPES_BY_NAME


def load_input(path: str, dtype: str = None, col: str = None) -> np.ndarray:
    """Input layer: npy / csv / txt / parquet / wav / raw binary
    (ref: pco_cli/src/input/mod.rs:46-60 — Binary/Csv/Parquet/Wav readers)."""
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".csv") or path.endswith(".txt"):
        kw = {}
        if col is not None:
            import csv as _csv

            with open(path, newline="") as f:
                header = next(_csv.reader(f))
            kw = {"usecols": [header.index(col)], "skiprows": 1}
        return np.loadtxt(
            path,
            dtype=NUMBER_TYPES_BY_NAME[dtype].np_dtype if dtype else np.float64,
            delimiter="," if path.endswith(".csv") else None,
            **kw,
        )
    if path.endswith(".parquet") or path.endswith(".pq"):
        import pyarrow as pa
        import pyarrow.parquet as pq

        def _is_supported(t):
            return (
                pa.types.is_integer(t) or pa.types.is_floating(t)
                or pa.types.is_timestamp(t) or pa.types.is_date32(t)
            )

        table = pq.read_table(path, columns=[col] if col else None)
        if col is None:
            numeric = [f.name for f in table.schema if _is_supported(f.type)]
            if not numeric:
                raise SystemExit("no numeric columns in parquet file; use --col")
            col = numeric[0]
        column = table.column(col)
        atype = column.type
        # Arrow temporal types map to their integer representations, like the
        # reference CLI (ref: pco_cli/src/dtypes.rs:388-410): Timestamp
        # (s/ms/us/ns) -> i64, Date32 -> i32
        if pa.types.is_timestamp(atype):
            arr = column.cast(pa.int64()).to_numpy(zero_copy_only=False)
        elif pa.types.is_date32(atype):
            arr = column.cast(pa.int32()).to_numpy(zero_copy_only=False)
        else:
            arr = column.to_numpy(zero_copy_only=False)
        return np.ascontiguousarray(arr)
    if path.endswith(".wav"):
        from scipy.io import wavfile

        _, samples = wavfile.read(path)
        return np.ascontiguousarray(samples.reshape(-1))
    if dtype is None:
        raise SystemExit("--dtype is required for raw binary inputs")
    return np.fromfile(path, dtype=NUMBER_TYPES_BY_NAME[dtype].np_dtype)


def build_config(args) -> ChunkConfig:
    mode_spec = ModeSpec()
    if args.mode:
        if args.mode == "classic":
            mode_spec = ModeSpec(ModeSpec.CLASSIC)
        elif args.mode == "dict":
            mode_spec = ModeSpec(ModeSpec.TRY_DICT)
        elif args.mode.startswith("float-mult:"):
            mode_spec = ModeSpec(ModeSpec.TRY_FLOAT_MULT, float(args.mode.split(":")[1]))
        elif args.mode.startswith("float-quant:"):
            mode_spec = ModeSpec(ModeSpec.TRY_FLOAT_QUANT, int(args.mode.split(":")[1]))
        elif args.mode.startswith("int-mult:"):
            mode_spec = ModeSpec(ModeSpec.TRY_INT_MULT, int(args.mode.split(":")[1]))
        elif args.mode != "auto":
            raise SystemExit(f"unknown mode {args.mode}")
    delta_spec = DeltaSpec()
    if args.delta:
        if args.delta == "none":
            delta_spec = DeltaSpec(DeltaSpec.NO_OP)
        elif args.delta == "lookback":
            delta_spec = DeltaSpec(DeltaSpec.TRY_LOOKBACK)
        elif args.delta.startswith("consecutive:"):
            delta_spec = DeltaSpec(DeltaSpec.TRY_CONSECUTIVE, int(args.delta.split(":")[1]))
        elif args.delta.startswith("conv1:"):
            delta_spec = DeltaSpec(DeltaSpec.TRY_CONV1, int(args.delta.split(":")[1]))
        elif args.delta != "auto":
            raise SystemExit(f"unknown delta {args.delta}")
    return ChunkConfig(
        compression_level=args.level,
        mode_spec=mode_spec,
        delta_spec=delta_spec,
        paging_spec=PagingSpec.equal_pages_up_to(args.chunk_n),
        enable_8_bit=True,
        ans_size_log_cap=getattr(args, "ans_cap", None),
    )


def _device(args):
    """The torch device a command runs on; None with --host."""
    if args.host:
        return None
    from pcodec_tpu_torch.ops.container_decode import _resolve_device

    try:
        return _resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"{e} (CLI: --device cpu runs those plain versions, --host the host codec)") from e


def cmd_compress(args):
    device = _device(args)
    nums = load_input(args.input, args.dtype, getattr(args, "col", None))
    config = build_config(args)
    t0 = time.perf_counter()
    if args.format == "pct":
        if device is None:
            from pcodec_tpu_torch.codec.container import container_compress

            data = container_compress(nums, config, page_n=args.page_n, chunk_n=args.chunk_n)
        else:
            from pcodec_tpu_torch.ops.assemble import encode_container_device

            data = encode_container_device(nums, config, page_n=args.page_n, chunk_n=args.chunk_n, device=device)
    else:
        data = simple_compress(nums, config)
    dt = time.perf_counter() - t0
    with open(args.output, "wb") as f:
        f.write(data)
    print(
        f"compressed {nums.nbytes} -> {len(data)} bytes "
        f"(ratio {nums.nbytes / len(data):.3f}) in {dt:.3f}s"
    )


def cmd_decompress(args):
    device = _device(args)
    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.perf_counter()
    if data[:4] == b"PCT1":
        if device is None:
            from pcodec_tpu_torch.codec.container import container_decompress

            nums = container_decompress(data)
        else:
            from pcodec_tpu_torch.ops.container_decode import decode_container_device

            nums = decode_container_device(data, device)
    elif device is None:
        nums, _ = simple_decompress(data)
    else:
        from pcodec_tpu_torch.ops.standalone_decode import decode_standalone_with_device

        nums, _ = decode_standalone_with_device(data, device=device)
    dt = time.perf_counter() - t0
    if args.output:
        if args.output.endswith(".npy"):
            np.save(args.output, nums)
        elif args.output.endswith(".csv") or args.output.endswith(".txt"):
            np.savetxt(args.output, nums, fmt="%s")
        else:
            nums.tofile(args.output)
        print(f"decompressed {len(nums)} numbers ({nums.dtype}) in {dt:.3f}s")
    else:
        for x in nums[: args.limit]:
            print(x)


def cmd_inspect(args):
    from pcodec_tpu_torch.inspect_mod import format_report, inspect_file

    with open(args.input, "rb") as f:
        data = f.read()
    report = inspect_file(data)
    if args.json:
        # serializable output like the reference's Serialize derives
        # (ref: pco_cli/src/inspect/handler.rs:24-110)
        import dataclasses
        import json as _json

        d = dataclasses.asdict(report)
        d["ratio"] = report.ratio
        print(_json.dumps(d, default=str, indent=1))
    else:
        print(format_report(report, verbose=args.verbose))


def _bench_codecs(config, device):
    """Codec surfaces like the reference bench's CodecInternal
    (ref: pco_cli/src/bench/codecs/mod.rs:47-93), under the JAX CLI's names;
    pct and pco_tpu decompress on `device` (pct also compresses there), or
    on the host where `device` is None (--host)."""
    import bz2
    import lzma
    import zlib

    from pcodec_tpu_torch.codec.container import (DEFAULT_CHUNK_N, DEFAULT_PAGE_N, container_compress,
                                                  container_decompress)
    from pcodec_tpu_torch.legacy import auto_compress, auto_decompress

    # standalone files compress on the host: neither package has a device encoder of them
    if device is None:
        pct = (lambda nums: container_compress(nums, config), lambda data, dtype: container_decompress(data))
        pco_tpu = (lambda nums: simple_compress(nums, config), lambda data, dtype: simple_decompress(data)[0])
    else:
        from pcodec_tpu_torch.ops.assemble import encode_container_device
        from pcodec_tpu_torch.ops.container_decode import decode_container_device
        from pcodec_tpu_torch.ops.standalone_decode import decode_standalone_device

        pct = (lambda nums: encode_container_device(nums, config, page_n=DEFAULT_PAGE_N, chunk_n=DEFAULT_CHUNK_N,
                                                    device=device),
               lambda data, dtype: decode_container_device(data, device))
        pco_tpu = (lambda nums: simple_compress(nums, config),
                   lambda data, dtype: decode_standalone_device(data, device))
    return {
        "pco_tpu": pco_tpu,
        "zlib": (
            lambda nums: zlib.compress(nums.tobytes(), 6),
            lambda data, dtype: np.frombuffer(zlib.decompress(data), dtype=dtype),
        ),
        "lzma": (
            lambda nums: lzma.compress(nums.tobytes(), preset=1),
            lambda data, dtype: np.frombuffer(lzma.decompress(data), dtype=dtype),
        ),
        "bz2": (
            lambda nums: bz2.compress(nums.tobytes(), 9),
            lambda data, dtype: np.frombuffer(bz2.decompress(data), dtype=dtype),
        ),
        # wrapped multi-page container, the analog of the reference's
        # `pcopage` bench codec (ref: pco_cli/src/bench/codecs/pcopage.rs)
        "pct": pct,
        # the reference's frozen predecessor, behind `full_bench` there
        # (ref: pco_cli/src/bench/codecs/qcompress.rs)
        "qco": (
            lambda nums: auto_compress(nums, level=config.compression_level),
            lambda data, dtype: auto_decompress(data)[0],
        ),
    }


def cmd_bench(args):
    device = _device(args)
    if args.input:
        nums = load_input(args.input, args.dtype, getattr(args, "col", None))
        name = args.input
    else:
        rng = np.random.default_rng(0)
        n = args.n
        incs = rng.integers(0, 120, n) + (rng.random(n) < 0.001) * rng.integers(0, 10**6, n)
        nums = np.cumsum(incs).astype(np.int64)
        name = f"synthetic_i64_{n}"
    config = build_config(args)
    surfaces = _bench_codecs(config, device)
    codecs = [c.strip() for c in args.codecs.split(",") if c.strip()]
    unknown = [c for c in codecs if c not in surfaces]
    if unknown:
        raise SystemExit(f"unknown codecs {unknown}; available: {sorted(surfaces)}")
    print(
        "note: reference bench codecs zstd/snappy/parquet are unavailable in "
        "this environment; comparing against zlib/lzma/bz2/qco instead",
        file=sys.stderr,
    )

    rows = []
    for codec in codecs:
        comp, decomp = surfaces[codec]
        compress_dts, decompress_dts = [], []
        data = None
        for _ in range(args.iters):
            t0 = time.perf_counter()
            data = comp(nums)
            compress_dts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            out = decomp(data, nums.dtype)
            decompress_dts.append(time.perf_counter() - t0)
            if not args.no_assertions:
                if nums.dtype.kind == "f":
                    w = {2: np.uint16, 4: np.uint32, 8: np.uint64}[nums.dtype.itemsize]
                    same = np.array_equal(out.view(w), nums.view(w))
                else:
                    same = np.array_equal(out, nums)
                if not same:
                    raise AssertionError(f"{codec}: the decoded numbers differ from the input")
        compress_dt = float(np.median(compress_dts))
        decompress_dt = float(np.median(decompress_dts))
        rows.append(
            {
                "input": name,
                "codec": codec,
                "compress_dt": compress_dt,
                "decompress_dt": decompress_dt,
                "compressed_size": len(data),
                "uncompressed_size": nums.nbytes,
            }
        )
        print(
            f"{name} [{codec}]: ratio {nums.nbytes / len(data):.3f}, compress "
            f"{nums.nbytes / compress_dt / 1e9:.3f} GB/s, decompress "
            f"{nums.nbytes / decompress_dt / 1e9:.3f} GB/s"
        )
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)


def _devices(sp):
    sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default): the CUDA kernels; cpu: their plain PyTorch versions")
    sp.add_argument("--host", action="store_true", help="the host codec, no torch device")


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m pcodec_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--level", type=int, default=8)
        sp.add_argument("--mode", default=None, help="auto|classic|dict|int-mult:B|float-mult:B|float-quant:K")
        sp.add_argument("--delta", default=None, help="auto|none|consecutive:K|lookback|conv1:K")
        sp.add_argument("--chunk-n", type=int, default=1 << 18)
        sp.add_argument("--ans-cap", type=int, default=None, help="cap the trained ans_size_log")
        sp.add_argument("--dtype", default=None, help="i32/i64/u32/u64/f32/f64/...")
        sp.add_argument("--col", default=None, help="column name (csv/parquet inputs)")

    sp = sub.add_parser("compress", help="compress a column of numbers to .pco/.pct")
    common(sp)
    sp.add_argument("input")
    sp.add_argument("output")
    sp.add_argument("--format", choices=("pco", "pct"), default="pco",
                    help="pco = standalone; pct = container (device-decodable)")
    sp.add_argument("--page-n", type=int, default=2048)
    _devices(sp)
    sp.set_defaults(fn=cmd_compress)

    sp = sub.add_parser("decompress", help="decompress a .pco or .pct file")
    sp.add_argument("input")
    sp.add_argument("output", nargs="?")
    sp.add_argument("--limit", type=int, default=10)
    _devices(sp)
    sp.set_defaults(fn=cmd_decompress)

    sp = sub.add_parser("inspect", help="dump .pco/.pct file structure")
    sp.add_argument("input")
    sp.add_argument("-v", "--verbose", action="store_true")
    sp.add_argument("--json", action="store_true", help="machine-readable report")
    sp.set_defaults(fn=cmd_inspect)

    sp = sub.add_parser(
        "bench", help="codec benchmark (median of iters)",
        description="Median wall seconds of --iters compress and decompress calls per codec, each from a numpy "
                    "array to a numpy array: on the card (pct, pco_tpu) a time includes the host's planning, the "
                    "upload and the download, not the kernels alone.")
    common(sp)
    sp.add_argument("--input", default=None)
    sp.add_argument("--n", type=int, default=1 << 20)
    sp.add_argument("--iters", type=int, default=3)
    sp.add_argument("--csv", default=None)
    sp.add_argument("--no-assertions", action="store_true")
    sp.add_argument("--codecs", default="pco_tpu", help="comma list: pco_tpu,pct,zlib,lzma,bz2,qco")
    _devices(sp)
    sp.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    args.fn(args)
