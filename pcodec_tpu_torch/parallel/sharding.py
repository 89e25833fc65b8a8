"""Decode and encode sharded over a list of devices: the PyTorch/CUDA
counterpart of the JAX package's `pcodec_tpu/parallel/sharding.py`.

Chains (a page of one latent var, ops/container_decode.py and
ops/container_encode.py) are independent, so the kernels shard over them
with no communication but the gather of their outputs:

    make_mesh                   the devices: every visible card, or a list
                                (["cpu"] * k runs the plain versions; one
                                card may be named several times)
    sharded_container_decode    each launch's chains cut into contiguous
                                shards at whole K2 blocks (CHAINS_PER_BLOCK
                                chains, one table each); each device gets
                                only the container words its chains stage
                                (their word0 and cursors rebased) and runs
                                K1 and K2; the outputs gather on the first
                                device in chain order, where the post (K3,
                                K4 and the joins) runs as it does on one
                                device
    sharded_decode_standalone   the same for a standalone .pco file, through
                                its container plan (plan_standalone)
    sharded_container_encode    training and the launch on the first device;
                                K5 and K6 per shard on contiguous chain and
                                row ranges (whole blocks; at chunk starts
                                where a K6 row is a page of several vars, so
                                no joint row is cut); the sections, lengths
                                and final states gather on the first device
                                for K7

Not carried over from the JAX module: pad_group_to_devices (shards here may
be uneven, so nothing pads) and sharded_decode_group (the port has no XLA
group route; its standalone decode is the container route).
"""

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pcodec_tpu_torch.ops import assemble as asm
from pcodec_tpu_torch.ops import container_decode as cd
from pcodec_tpu_torch.ops import container_encode as ce
from pcodec_tpu_torch.ops.standalone_decode import plan_standalone


def make_mesh(devices=None) -> List[torch.device]:
    """The devices to shard over: every visible CUDA device by default
    (RuntimeError when there is none), else `devices` as torch.device (a
    card may repeat, and "cpu" runs the kernels' plain versions)."""
    if devices is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise RuntimeError("no CUDA device is available; pass devices=['cpu'] * k to shard on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [cd._resolve_device(d) for d in devices]
    if not out:
        raise ValueError("make_mesh needs at least one device")
    for d in out:
        if d.type == "cuda" and (d.index or 0) >= torch.cuda.device_count():
            raise RuntimeError(f"{d} is not a visible CUDA device ({torch.cuda.device_count()} visible)")
    return out


def even_cuts(points: np.ndarray, n_shards: int) -> List[int]:
    """Indices into `points` (the positions a range may be cut at, sorted,
    from 0 to its end) of n_shards + 1 bounds: each inner bound the point
    nearest an even split, never before the bound ahead of it."""
    end = int(points[-1])
    idx = [0]
    for k in range(1, n_shards):
        j = int(np.argmin(np.abs(points - end * k / n_shards)))
        idx.append(max(j, idx[-1]))
    return idx + [len(points) - 1]


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@dataclass
class DecodeShard:
    device: torch.device
    lkey: tuple  # the launch
    chains: Tuple[int, int]  # [c0, c1) of the launch's chains
    span: Tuple[int, int]  # [lo, hi) the container words uploaded
    words: torch.Tensor
    arrays: Dict[str, torch.Tensor]


@dataclass
class ShardedArrays:
    post: cd.DeviceArrays  # the post's tables on the first device
    shards: List[DecodeShard] = field(default_factory=list)


def upload_sharded(plan: cd.ContainerPlan, devices) -> ShardedArrays:
    """Each launch's chains cut into one contiguous shard a device (whole K2
    blocks; a shard may be empty and is then left out), each uploaded with
    only the container words it stages (upload_launch_shard); the post's
    tables on the first device."""
    devices = make_mesh(devices)
    sharded = ShardedArrays(cd.upload_post(plan, devices[0]))
    for lkey, cp in plan.launches.items():
        points = np.arange(0, cp.n_chains + 1, cd.CHAINS_PER_BLOCK)
        bounds = points[even_cuts(points, len(devices))]
        for d, c0, c1 in zip(devices, bounds[:-1].tolist(), bounds[1:].tolist()):
            if c1 > c0:
                words, a, span = cd.upload_launch_shard(plan, lkey, c0, c1, d)
                sharded.shards.append(DecodeShard(d, lkey, (c0, c1), span, words, a))
    return sharded


def decode_sharded(plan: cd.ContainerPlan, sharded: ShardedArrays) -> torch.Tensor:
    """K1 and K2 on every shard (all launched before the first gather), the
    outputs gathered on the first device in chain order, then the post
    there (K3, B1, B3 and K4, whose wrappers refuse a base on another
    device): (n,) int64 memory bits, as decode_plan's."""
    outs = [(s.lkey, cd.run_launch(plan.launches[s.lkey], s.words, s.arrays)) for s in sharded.shards]
    dev0 = sharded.post.device
    parts: Dict[tuple, list] = {}
    for lkey, o in outs:
        parts.setdefault(lkey, []).append(o.to(dev0))
    return cd.post_chunks(plan, {k: v[0] if len(v) == 1 else torch.cat(v) for k, v in parts.items()}, sharded.post)


def sharded_container_decode_tensor(data: bytes, devices=None, plan: Optional[cd.ContainerPlan] = None) -> torch.Tensor:
    """Decode a PCT container sharded over `devices` (make_mesh); the
    numbers' memory bits as an (n,) int64 tensor on the first device. A
    standalone file decodes the same way with plan=plan_standalone(data)."""
    plan = plan or cd.plan_container(data)
    return decode_sharded(plan, upload_sharded(plan, devices))


def sharded_container_decode(data: bytes, devices=None, plan: Optional[cd.ContainerPlan] = None) -> np.ndarray:
    """sharded_container_decode_tensor's numbers as a numpy array of the
    container's type."""
    plan = plan or cd.plan_container(data)
    return cd.to_numbers(sharded_container_decode_tensor(data, devices, plan), plan.nt)


def sharded_decode_standalone(data: bytes, devices=None) -> np.ndarray:
    """Decode a standalone .pco file sharded over `devices`: its container
    plan (plan_standalone, 1,024-number chains) through
    sharded_container_decode."""
    return sharded_container_decode(data, devices, plan_standalone(data))


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------


@dataclass
class EncodeShard:
    device: torch.device
    chains: Tuple[int, int]  # [c0, c1) of the launch's chains
    rows: Tuple[int, int]  # [r0, r1) of K6's rows
    arrays: Dict[str, torch.Tensor]


@dataclass
class ShardedImage:
    stitch: dict  # K7's arrays on the first device (upload_stitch)
    shards: List[EncodeShard] = field(default_factory=list)


def encode_cut_points(plan: asm.ImagePlan):
    """(chain points, row points) where an image's launch may be cut: every
    block where a K6 row is a chain; else each chunk's first chain and
    first page, so that a shard holds whole chunks, every chain of its rows
    among them."""
    L = plan.launch
    if L.row_chains is None:
        points = np.arange(0, L.n_chains + 1, cd.CHAINS_PER_BLOCK)
        return points, points
    chains, nxt = [L.n_chains], L.n_chains
    for vs in reversed(L.var_starts):  # a chunk's first chain; a trivial chunk's is the next one's
        nxt = min([v for v in vs.values() if v >= 0] + [nxt])
        chains.append(nxt)
    rows = np.append(plan.layout.page0_of_chunk(), L.n_rows)
    return np.asarray(chains[::-1], np.int64), rows


def upload_sharded_image(plan: asm.ImagePlan, devices) -> ShardedImage:
    """The launch cut into one shard a device at encode_cut_points (an
    empty shard is left out), each shard's chains and rows uploaded to its
    device (upload_launch; the latents of a device-trained plan copied
    from the first device), K7's arrays on the first device."""
    devices = make_mesh(devices)
    L = plan.launch
    img = ShardedImage(asm.upload_stitch(plan, devices[0]))
    chains, rows = encode_cut_points(plan)
    idx = even_cuts(chains, len(devices))
    for d, k0, k1 in zip(devices, idx[:-1], idx[1:]):
        c, r = (int(chains[k0]), int(chains[k1])), (int(rows[k0]), int(rows[k1]))
        if c[1] > c[0] or (r[1] > r[0] and L.row_chains is not None):
            img.shards.append(EncodeShard(d, c, r, ce.upload_launch(L, d, c, r)))
    if not img.shards:  # no chain and no row: the launch's empty outputs
        img.shards.append(EncodeShard(devices[0], (0, 0), (0, L.n_rows), ce.upload_launch(L, devices[0])))
    return img


def run_image_sharded(plan: asm.ImagePlan, img: ShardedImage):
    """K5 and K6 on every shard (all launched before the first gather),
    their sections, final states, section lengths and bits gathered on the
    first device in shard order, then K7 there. Returns run_image's
    (head_words, body_words, head_bytes, body_bytes)."""
    outs = [ce.encode_launch(plan.launch, s.arrays) for s in img.shards]
    dev0 = img.stitch["moments"].device
    got = [torch.cat([o[k].to(dev0) for o in outs]) for k in range(5)]
    head, body, body_bytes = asm.image_assemble(plan, img.stitch, *got)
    return head, body, plan.head_bytes, body_bytes


def sharded_container_encode(nums, config=None, devices=None, page_n: int = 1024, chunk_n: int = 1 << 20,
                             nums_host: Optional[np.ndarray] = None):
    """Encode `nums` (a numpy array, or a tensor already on the first
    device; nums_host as for plan_image) to PCT container bytes with K5 and
    K6 sharded over `devices` (make_mesh): training and the launch on the
    first device (plan_image), then upload_sharded_image and
    run_image_sharded. The bytes equal encode_container_device's. Returns
    (bytes, stats): stats["device_chunks"] the chunks whose pages K5 and K6
    code, those with a var that is not trivial (JAX counts its chunks of
    kind "device", pallas_encode.py:1104, which also leaves out chunks of
    several vars or lookback and chunks past its kernels' table and section
    caps: limits the port's kernels do not have), "chunks", "trained_on"
    and per shard its device, chains and rows."""
    devices = make_mesh(devices)
    plan = asm.plan_image(nums, config, page_n, chunk_n, devices[0], nums_host)
    img = upload_sharded_image(plan, devices)
    data = asm.file_image_to_bytes(*run_image_sharded(plan, img))
    coded = sum(any(not vj.trivial for vj in job.vars) for job in plan.enc.jobs)
    return data, {"device_chunks": coded, "chunks": len(plan.enc.jobs), "trained_on": plan.trained_on,
                  "shards": [{"device": str(s.device), "chains": s.chains, "rows": s.rows} for s in img.shards]}
