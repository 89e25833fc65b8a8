"""The port's entry functions: the counterparts of the JAX package's
`__graft_entry__.entry` and `__graft_entry__.dryrun_multichip`.

    fn, args = entry()        # on the card; entry(device="cpu") on the CPU
    checksum = fn(*args)      # (1,) int64 tensor: the wrapping u64 sum of
                              # the decoded numbers' memory bits

The input is the flagship's shape at a small size: 4,096 numbers of
np.cumsum(rng.integers(0, 50, 4096)) (seed 0), an order-1 consecutive delta,
written to a PCT container at page_n 256 by the port's own encoder
(encode_container_device, trained on the device). fn runs the device part
of the container decode (K1, K2 and the post) on the uploaded plan.

    dryrun_multichip(4)                        # on four cards
    dryrun_multichip(4, devices=["cuda:0"] * 4)  # four shards on one card

encodes and decodes the seven mode and delta families of the JAX dry run
sharded over the devices (parallel/sharding.py) and raises unless the
bytes equal container_compress's and the numbers the source's.
"""

import numpy as np
import torch

from pcodec_tpu_torch.codec.chunk_config import ChunkConfig, DeltaSpec, ModeSpec
from pcodec_tpu_torch.codec.container import container_compress
from pcodec_tpu_torch.ops.assemble import encode_container_device
from pcodec_tpu_torch.ops.container_decode import _resolve_device, decode_plan, plan_container, upload_plan
from pcodec_tpu_torch.parallel.sharding import make_mesh, sharded_container_decode, sharded_container_encode


def entry_numbers() -> np.ndarray:
    """The entry's 4,096 numbers."""
    rng = np.random.default_rng(0)
    return np.cumsum(rng.integers(0, 50, 4096)).astype(np.int64)


def entry(device="cuda"):
    """(fn, args): fn(*args) decodes the entry's container on `device` (the
    GPU unless the caller asks for the CPU) and returns its checksum."""
    device = _resolve_device(device)
    cfg = ChunkConfig(delta_spec=DeltaSpec(DeltaSpec.TRY_CONSECUTIVE, 1))
    data = encode_container_device(entry_numbers(), cfg, page_n=256, device=device)
    plan = plan_container(data)

    def fn(arrays):
        return decode_plan(plan, arrays).sum(0, keepdim=True)

    return fn, (upload_plan(plan, device),)


DRYRUN_PAGE_N = 256
DRYRUN_CHUNK_N = 1024  # a chunk a device at 1,024 numbers a device


def dryrun_cases(n_devices: int) -> dict:
    """The JAX dry run's seven cases at 1,024 x n_devices numbers (its
    seed-0 draws, in its order): name -> (numbers, config)."""
    rng = np.random.default_rng(0)
    n = 1024 * n_devices
    t = np.arange(n, dtype=np.float64)
    return {
        "classic_i64_delta1": (np.cumsum(rng.integers(0, 50, n)).astype(np.int64),
                               ChunkConfig(delta_spec=DeltaSpec(DeltaSpec.TRY_CONSECUTIVE, 1))),
        "floatmult_f64": ((rng.integers(-5000, 5000, n) * 0.01).astype(np.float64), ChunkConfig()),
        "dict_i64": (np.array([3, 99, 1234567, -5], np.int64)[rng.integers(0, 4, n)],
                     ChunkConfig(mode_spec=ModeSpec(ModeSpec.TRY_DICT))),
        "lookback_i64": (np.tile(rng.integers(0, 10**6, 512).astype(np.int64), n // 512) + rng.integers(0, 2, n),
                         ChunkConfig(delta_spec=DeltaSpec(DeltaSpec.TRY_LOOKBACK))),
        "intmult_i64": ((np.cumsum(rng.integers(1, 30, n)) * 1_000_000_000 + rng.integers(0, 4, n)).astype(np.int64),
                        ChunkConfig(mode_spec=ModeSpec(ModeSpec.TRY_INT_MULT, 10**9))),
        "floatquant_f16": ((np.round(rng.standard_normal(n) * 16) / 16).astype(np.float16),
                           ChunkConfig(mode_spec=ModeSpec(ModeSpec.TRY_FLOAT_QUANT, 6))),
        "conv1_i32": (((1 << 16) * np.sin(0.01 * t) + rng.integers(-16, 16, n)).astype(np.int32),
                      ChunkConfig(delta_spec=DeltaSpec(DeltaSpec.TRY_CONV1, 4))),
    }


def dryrun_multichip(n_devices: int, devices=None) -> list:
    """Encode and decode each of dryrun_cases sharded over n_devices
    devices: every visible card up to n_devices (RuntimeError with fewer),
    or `devices` (n_devices of them; a card may repeat, "cpu" runs the
    plain versions). The numbers are cut into DRYRUN_CHUNK_N-number chunks
    at page_n DRYRUN_PAGE_N, so each device holds a chunk. Raises unless
    sharded_container_encode's bytes equal container_compress's and
    sharded_container_decode's numbers equal the source bit for bit.
    Returns the cases' names."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices, {have} visible")
        devices = [f"cuda:{i}" for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) was given {len(devices)} devices")
    mesh = make_mesh(devices)
    done = []
    for name, (nums, cfg) in dryrun_cases(n_devices).items():
        data = container_compress(nums, cfg, page_n=DRYRUN_PAGE_N, chunk_n=DRYRUN_CHUNK_N)
        enc, _ = sharded_container_encode(nums, cfg, mesh, page_n=DRYRUN_PAGE_N, chunk_n=DRYRUN_CHUNK_N)
        if enc != data:
            raise AssertionError(f"{name}: the sharded encode differs from container_compress's bytes")
        decoded = sharded_container_decode(data, mesh)
        if not np.array_equal(decoded.view(np.uint8), nums.view(np.uint8)):
            raise AssertionError(f"{name}: the sharded decode differs from the source")
        done.append(name)
    return done
