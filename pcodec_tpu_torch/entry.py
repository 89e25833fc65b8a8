"""The port's entry function: the counterpart of the JAX package's
`__graft_entry__.entry`.

    fn, args = entry()        # on the card; entry(device="cpu") on the CPU
    checksum = fn(*args)      # (1,) int64 tensor: the wrapping u64 sum of
                              # the decoded numbers' memory bits

The input is the flagship's shape at a small size: 4,096 numbers of
np.cumsum(rng.integers(0, 50, 4096)) (seed 0), an order-1 consecutive delta,
written to a PCT container at page_n 256 by the port's own encoder
(encode_container_device, trained on the device). fn runs the device part
of the container decode (K1, K2 and the post) on the uploaded plan.
"""

import numpy as np

from pcodec_tpu_torch.codec.chunk_config import ChunkConfig, DeltaSpec
from pcodec_tpu_torch.ops.assemble import encode_container_device
from pcodec_tpu_torch.ops.container_decode import _resolve_device, decode_plan, plan_container, upload_plan


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
