"""Decode and encode sharded over a list of devices (parallel/sharding.py)."""

from pcodec_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    sharded_container_decode,
    sharded_container_decode_tensor,
    sharded_container_encode,
    sharded_decode_standalone,
)
