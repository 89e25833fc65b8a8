"""The port's entry points: its command line (`python -m pcodec_tpu_torch`)
against the JAX package's (`pcodec_tpu/cli.py`), and its entry function
(`pcodec_tpu_torch.entry`) against numpy. On the CPU the CLI runs with
`--device cpu` (the kernels' plain versions); every comparison is exact.
"""

import numpy as np
import pytest
import torch

from pcodec_tpu.cli import main as ref_main

from pcodec_tpu_torch.cli import main
from pcodec_tpu_torch.entry import entry, entry_numbers

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs


@pytest.fixture
def numbers(tmp_path):
    rng = np.random.default_rng(31)
    nums = np.cumsum(rng.integers(0, 100, 9000) + (rng.random(9000) < 0.01) * 10**6).astype(np.int64)
    path = tmp_path / "x.npy"
    np.save(path, nums)
    return nums, path


PCT_FLAGS = ["--format", "pct", "--page-n", "256", "--chunk-n", "4096", "--delta", "lookback"]


@pytest.mark.parametrize("fmt", ["pct", "pco"])
def test_round_trip_on_cpu(numbers, tmp_path, fmt):
    """Exact: compress then decompress with --device cpu returns the
    numbers (PCT through the device encoder and decoder, .pco through the
    host encoder and the device decoder)."""
    nums, path = numbers
    flags = PCT_FLAGS if fmt == "pct" else []
    main(["compress", str(path), str(tmp_path / "x.out"), *flags, "--device", "cpu"])
    main(["decompress", str(tmp_path / "x.out"), str(tmp_path / "y.npy"), "--device", "cpu"])
    assert np.array_equal(np.load(tmp_path / "y.npy"), nums)


def test_pct_bytes_equal_the_jax_cli_host_output(numbers, tmp_path):
    """Exact: the port's PCT file (trained and encoded on the device, here
    the CPU) is the JAX CLI's host container_compress output at the same
    flags."""
    nums, path = numbers
    main(["compress", str(path), str(tmp_path / "port.pct"), *PCT_FLAGS, "--device", "cpu"])
    ref_main(["compress", str(path), str(tmp_path / "ref.pct"), *PCT_FLAGS])
    assert (tmp_path / "port.pct").read_bytes() == (tmp_path / "ref.pct").read_bytes()


@pytest.mark.parametrize("flags", [[], ["--json"]])
def test_inspect_equals_the_jax_cli(numbers, tmp_path, capsys, flags):
    """Exact: `inspect` prints the JAX CLI's report (text and --json) of
    the same PCT file."""
    _, path = numbers
    ref_main(["compress", str(path), str(tmp_path / "x.pct"), *PCT_FLAGS])
    capsys.readouterr()
    main(["inspect", str(tmp_path / "x.pct"), *flags])
    got = capsys.readouterr().out
    ref_main(["inspect", str(tmp_path / "x.pct"), *flags])
    assert got == capsys.readouterr().out and got


def test_without_a_card_the_default_device_exits_non_zero(numbers, tmp_path):
    """Compress and decompress run on the card by default and do not fall
    back: without CUDA and without --device cpu or --host they exit
    non-zero with the device's message."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    _, path = numbers
    for argv in (["compress", str(path), str(tmp_path / "x.pct"), "--format", "pct"],
                 ["decompress", str(tmp_path / "x.pct")]):
        with pytest.raises(SystemExit, match="no CUDA device") as e:
            main(argv)
        assert e.value.code != 0
    main(["compress", str(path), str(tmp_path / "x.pct"), "--format", "pct", "--host"])
    assert (tmp_path / "x.pct").exists()


def test_entry_checksum_equals_numpy():
    """Exact: the entry function's decode checksum (device="cpu") is the
    wrapping u64 sum of the numbers' bits."""
    fn, args = entry(device="cpu")
    got = fn(*args)
    assert got.shape == (1,) and got.dtype == torch.int64
    assert int(got.item()) & (2**64 - 1) == int(entry_numbers().view(np.uint64).sum())


BENCH_FLAGS = ["bench", "--n", "4096", "--iters", "1", "--codecs", "pco_tpu,pct,zlib,qco"]


def _csv_rows(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


@pytest.fixture(scope="module")
def jax_bench_rows(tmp_path_factory):
    path = tmp_path_factory.mktemp("bench") / "jax.csv"
    ref_main([*BENCH_FLAGS, "--csv", str(path)])
    return _csv_rows(path)


@pytest.mark.parametrize("where", [["--device", "cpu"], ["--host"]])
def test_bench_csv_equals_the_jax_cli(jax_bench_rows, tmp_path, where):
    """Exact: `bench` writes the JAX CLI's CSV header, and per codec the
    same input name, compressed_size and uncompressed_size (the round trip
    asserted inside, bitwise), on the plain versions and on the host."""
    main([*BENCH_FLAGS, "--csv", str(tmp_path / "port.csv"), *where])
    rows = _csv_rows(tmp_path / "port.csv")
    assert rows[0] == jax_bench_rows[0] == ["input", "codec", "compress_dt", "decompress_dt", "compressed_size",
                                            "uncompressed_size"]
    assert [(r[0], r[1], r[4], r[5]) for r in rows[1:]] == [(r[0], r[1], r[4], r[5]) for r in jax_bench_rows[1:]]
    assert [r[1] for r in rows[1:]] == ["pco_tpu", "pct", "zlib", "qco"]


@pytest.mark.parametrize("argv", [["--codecs", "pco_tpu,zstd", "--host"], []])
def test_bench_exits_non_zero_on_an_unknown_codec_or_without_a_card(argv):
    """An unknown codec exits non-zero, as in the JAX CLI; without CUDA
    and without --device cpu or --host, so does the default device."""
    if not argv and torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device runs")
    with pytest.raises(SystemExit, match="unknown codecs" if argv else "no CUDA device") as e:
        main(["bench", "--n", "4096", "--iters", "1", *argv])
    assert e.value.code != 0
