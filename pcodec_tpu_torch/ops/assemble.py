"""Device-side PCT file image: the PyTorch/CUDA counterpart of the JAX
package's `pcodec_tpu/ops/assemble.py`, single-latent-var path only.

The encode's sections (ops/container_encode.py, K5 and K6) stay on the card
and are stitched there, with the page metas and the container directory,
into the byte-exact `.pct` file image. The head (PCT header + directory) is
dense and word-aligned, so it is a plain concat. The body is the wrapped
pco stream: per chunk [prefix: wrapped header (chunk 0) + chunk meta, host
bytes], then per page [page meta | section bytes]. Pages land at arbitrary
byte offsets, so the body is built from two row streams:

  A: one row per page, [page meta | sections], packed in plain torch from
     the final tANS states and the delta moments
  C: one row per chunk, its prefix bytes

Each row is pre-shifted by its destination offset mod 4 bytes, after which
placement is a word-level OR: rows share at most their boundary words, and
out-of-payload bits are zero. K7 (`image_stitch`, csrc/image_stitch.cu)
does the placement.

    plan_image       host: training (container_encode.plan_encode, its
                     sorts on the card), the launch, the chunk prefixes,
                     the head's host part
    upload_image     launch and layout arrays to the card
    run_image        K5 -> glue -> K6 -> prepare_image (plain torch) -> K7
    file_image_to_bytes
                     reads the image back as bytes

Entry points: encode_container_image_device (the image on the card) and
encode_container_device (its bytes).

Multi-latent-var and lookback chunks raise NotImplementedError (ROADMAP.md
item 4b).
"""

import struct
from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from pcodec_tpu_torch.codec import container as ctn
from pcodec_tpu_torch.codec.wrapped import FileCompressor
from pcodec_tpu_torch.format.bitio import BitWriter
from pcodec_tpu_torch.ops import kernels
from pcodec_tpu_torch.ops.container_decode import BATCH, _resolve_device
from pcodec_tpu_torch.ops.container_encode import (
    M32,
    EncodeLaunch,
    EncodePlan,
    _to_i32,
    build_encode_launch,
    encode_launch,
    plan_encode,
    upload_launch,
)
from pcodec_tpu_torch.ops.decode import _check_cuda

i64 = torch.int64


@dataclass(frozen=True)
class ImageLayout:
    page_n: int
    n_chunks: int
    pages_per_chunk: tuple  # (n_full, rem_page_len) per chunk
    orders: tuple  # consecutive delta order per chunk
    sls: tuple  # ans_size_log per chunk
    ts: tuple  # real tANS table size per chunk; 0 for a trivial var
    bits: tuple  # primary latent bits per chunk
    meta_bytes: tuple  # page meta bytes per chunk
    pfx_bytes: tuple  # chunk prefix bytes per chunk

    @property
    def n_pages(self):
        return tuple(nf + (1 if rem else 0) for nf, rem in self.pages_per_chunk)

    @property
    def total_pages(self):
        return int(sum(self.n_pages))

    @property
    def max_order(self):
        return max(self.orders) if self.orders else 0

    def page_lens(self):
        out = []
        for nf, rem in self.pages_per_chunk:
            out.extend([self.page_n] * nf)
            if rem:
                out.append(rem)
        return np.asarray(out, np.int64)

    def chunk_of_page(self):
        return np.repeat(np.arange(self.n_chunks, dtype=np.int64), np.asarray(self.n_pages, np.int64))

    def page0_of_chunk(self):
        return np.cumsum([0] + list(self.n_pages[:-1])).astype(np.int64)

    def dir_entry_pages(self):
        """(page, batch) of every directory entry, in file order."""
        nb = -(-self.page_lens() // BATCH)
        pages = np.repeat(np.arange(len(nb), dtype=np.int64), nb)
        batches = np.concatenate([np.arange(k, dtype=np.int64) for k in nb])
        return pages, batches


@dataclass
class ImagePlan:
    layout: ImageLayout
    enc: EncodePlan
    launch: EncodeLaunch
    chain_of_page: np.ndarray  # (R,) int64 chain of each page; n_chains for a trivial var
    moments: np.ndarray  # (R, max_order) uint64 consecutive-delta moments per page
    head_host: bytes  # PCT header + chunk_ns + chunk_meta_bytes
    prefixes: List[bytes]  # per chunk; chunk 0's starts with the wrapped header
    head_bytes: int

    @property
    def identity(self) -> bool:
        """Page p is chain p: no trivial chunk and no padding between chunks."""
        R = len(self.chain_of_page)
        return R <= self.launch.n_chains and bool(np.array_equal(self.chain_of_page, np.arange(R)))


def plan_image(nums: np.ndarray, config=None, page_n: int = 1024, chunk_n: int = 1 << 20,
               device="cuda") -> ImagePlan:
    """Host part of the device file image (the JAX `plan_image`, fed by the
    host planner, whose sorts run on `device`): training, the launch, and
    the host-serialized bytes."""
    if len(nums) == 0:
        raise ValueError("plan_image needs at least one number")
    enc = plan_encode(nums, config, page_n, chunk_n, device)
    L = build_encode_launch(enc)

    orders, sls, tss, bits, meta_bytes = [], [], [], [], []
    for job in enc.jobs:
        meta = job.cc.meta
        b = meta.mode.primary_latent_type(enc.nt.latent).bits
        sl = meta.per_latent_var.primary.ans_size_log
        orders.append(job.order)
        sls.append(int(sl))
        tss.append(0 if job.trivial else int(job.tables[4]))
        bits.append(int(b))
        meta_bytes.append((job.order * b + 4 * sl + 7) // 8)

    w = BitWriter()
    FileCompressor().write_header(w)
    wrapped_hdr = w.to_bytes()
    prefixes = []
    for ci, job in enumerate(enc.jobs):
        mw = BitWriter()
        job.cc.write_meta(mw)
        prefixes.append((wrapped_hdr if ci == 0 else b"") + mw.to_bytes())

    layout = ImageLayout(
        page_n=page_n, n_chunks=len(enc.chunk_ns),
        pages_per_chunk=tuple((cn // page_n, cn % page_n) for cn in enc.chunk_ns),
        orders=tuple(orders), sls=tuple(sls), ts=tuple(tss), bits=tuple(bits),
        meta_bytes=tuple(meta_bytes), pfx_bytes=tuple(len(p) for p in prefixes),
    )
    R = layout.total_pages
    chain_of_page = np.full(R, L.n_chains, dtype=np.int64)
    moments = np.zeros((R, layout.max_order), dtype=np.uint64)
    for ci, (p0, npg) in enumerate(zip(layout.page0_of_chunk(), layout.n_pages)):
        if L.chain_start[ci] >= 0:
            chain_of_page[p0 : p0 + npg] = L.chain_start[ci] + np.arange(npg)
        o = layout.orders[ci]
        if o:
            moments[p0 : p0 + npg, :o] = np.stack(
                [info.per_latent_var.primary.delta_state for info in enc.jobs[ci].cc.page_infos]
            ).astype(np.uint64)

    # head: PCT header (dir_bytes is static) + chunk_ns + chunk_meta_bytes;
    # the device appends page_bytes and the u16 ans/off entries (4E bytes)
    E = int(sum(-(-ln // BATCH) for ln in layout.page_lens()))
    dir_bytes = 8 * layout.n_chunks + 4 * R + 4 * E
    header = struct.pack(ctn.HEADER_FMT, ctn.MAGIC, enc.nt.type_byte, 1, 0, page_n, enc.n,
                         layout.n_chunks, dir_bytes)
    cmb = [len(p) for p in prefixes]
    cmb[0] -= len(wrapped_hdr)  # the wrapped header is no part of chunk 0's meta
    head_host = (header + np.asarray(enc.chunk_ns, np.uint32).tobytes()
                 + np.asarray(cmb, np.uint32).tobytes())
    return ImagePlan(layout=layout, enc=enc, launch=L, chain_of_page=chain_of_page,
                     moments=moments, head_host=head_host, prefixes=prefixes,
                     head_bytes=len(head_host) + 4 * R + 4 * E)


def upload_image(plan: ImagePlan, device="cuda") -> dict:
    """The launch arrays and the layout arrays that prep reads, on `device`."""
    device = _resolve_device(device)
    lay = plan.layout

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cofp = lay.chunk_of_page()
    pw = max(1, -(-max(lay.pfx_bytes) // 4))
    pfx = np.zeros((lay.n_chunks, 4 * pw), np.uint8)
    for ci, p in enumerate(plan.prefixes):
        pfx[ci, : len(p)] = np.frombuffer(p, np.uint8)
    ep, eb = lay.dir_entry_pages()
    groups = {}
    for ci, key in enumerate(zip(lay.orders, lay.sls, lay.bits)):
        groups.setdefault(key, []).append(ci)
    pfx_row = np.zeros(lay.total_pages, np.int64)
    pfx_row[lay.page0_of_chunk()] = lay.pfx_bytes
    a = upload_launch(plan.launch, device)
    a.update({
        "chain_of_page": t(plan.chain_of_page),
        "ts_row": t(np.asarray(lay.ts, np.int64)[cofp]),
        "meta_bytes_row": t(np.asarray(lay.meta_bytes, np.int64)[cofp]),
        "pfx_bytes_row": t(pfx_row),
        "page0": t(lay.page0_of_chunk()),
        "pfx_bytes": t(np.asarray(lay.pfx_bytes, np.int64)),
        "pfx_words": t(pfx.view(np.uint32).astype(np.int64)),
        "moments": t(plan.moments.view(np.int64)),
        "entry_page": t(ep),
        "entry_batch": t(eb),
        "head_host_words": t(np.frombuffer(plan.head_host, np.uint32).astype(np.int64)),
        "meta_groups": {key: t(np.nonzero(np.isin(cofp, cis))[0]) for key, cis in groups.items()},
    })
    return a


# ---------------------------------------------------------------------------
# prep: plain torch (XLA in the JAX package)
# ---------------------------------------------------------------------------


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits by 1 <= s <= 63."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _byte_shift_rows(rows: torch.Tensor, s_bytes: torch.Tensor) -> torch.Tensor:
    """Shift each row of u32 words (int64) right by s_bytes in 0..3 of the
    little-endian bit stream: payload bit b -> bit b + 8 s. (R, W) -> (R,
    W + 1)."""
    z = rows.new_zeros((rows.shape[0], 1))
    cur = torch.cat([rows, z], 1)
    prev = torch.cat([z, rows], 1)
    s = (s_bytes * 8)[:, None]
    s_safe = s.clamp(min=1)
    shifted = ((cur << s_safe) & M32) | (prev >> (32 - s_safe))
    return torch.where(s == 0, cur, shifted)


def _pack_meta_fields(fields, G: int, mw: int, device) -> torch.Tensor:
    """Bit-pack (values (G,) int64 u64 bits, n_bits) fields LSB-first into
    (G, mw) u32 words held in int64 (the PageMeta.write_to layout)."""
    words = [torch.zeros(G, dtype=i64, device=device) for _ in range(mw)]
    cursor = 0
    for val, nb in fields:
        if nb <= 0:
            continue
        if nb < 64:
            val = val & ((1 << nb) - 1)
        for w in range(cursor >> 5, min((cursor + nb - 1) >> 5, mw - 1) + 1):
            sh = cursor - 32 * w
            contrib = (val << sh) if sh >= 0 else _srl(val, -sh)
            words[w] = words[w] | (contrib & M32)
        cursor += nb
    return torch.stack(words, 1)


def _pack_meta_group(moments, idxs, order: int, sl: int, bits: int, mw: int) -> torch.Tensor:
    """Page metas of one (order, sl, bits) group: `order` delta moments at
    `bits` each, then the 4 final tANS state indices at `sl` bits."""
    fields = [(moments[:, k], bits) for k in range(order)] + [(idxs[:, k], sl) for k in range(4)]
    return _pack_meta_fields(fields, idxs.shape[0], mw, idxs.device)


def _pages(plan: ImagePlan, a: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-page rows of a per-chain tensor; zeros for a trivial var's pages."""
    R = plan.layout.total_pages
    if plan.identity:
        return x[:R]
    ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return ext[a["chain_of_page"]]


def prepare_image(plan: ImagePlan, a: dict, sections, states, ans_len, off_len, total_bits) -> dict:
    """Row streams A and C with their destination words (F0) and lengths
    (lenW), the head words, and `sizes`: the body's byte count and the end
    word of the farthest row, from the launch's outputs (the JAX
    `_prepare_image` and `_core_prep`). Rows are int32."""
    lay = plan.layout
    dev = sections.device
    R = lay.total_pages
    tb = _pages(plan, a, total_bits)
    sec = _pages(plan, a, sections).to(i64) & M32
    idxs = _pages(plan, a, states) - a["ts_row"][:, None]  # trivial var: 0 - 0
    mom = a["moments"]

    mw = max(1, -(-max(o * b + 4 * sl + 24 for o, sl, b in zip(lay.orders, lay.sls, lay.bits)) // 32))
    if len(a["meta_groups"]) == 1:
        ((o, sl, b),) = a["meta_groups"]
        meta = _pack_meta_group(mom, idxs, o, sl, b, mw)
    else:
        meta = torch.zeros((R, mw), dtype=i64, device=dev)
        for (o, sl, b), sel in a["meta_groups"].items():
            meta.index_copy_(0, sel, _pack_meta_group(mom[sel], idxs[sel], o, sl, b, mw))

    mb_row, pfx_row = a["meta_bytes_row"], a["pfx_bytes_row"]
    sec_bytes = (tb + 7) >> 3
    row_total = pfx_row + mb_row + sec_bytes
    starts = torch.cumsum(row_total, 0) - row_total
    body_bytes = starts[-1] + row_total[-1]
    off_meta = starts + pfx_row

    # [page meta | sections]: the sections start meta_bytes into the row
    SECW = sec.shape[1]
    WAB = max(max(lay.meta_bytes) // 4 + SECW + 1, mw)
    rowsAB0 = torch.zeros((R, WAB), dtype=i64, device=dev)
    rowsAB0[:, :mw] = meta
    if len(set(lay.meta_bytes)) == 1:
        spans = [(0, R, lay.meta_bytes[0])]
    else:
        spans = zip(lay.page0_of_chunk(), lay.n_pages, lay.meta_bytes)
    for p0, npg, mb in spans:
        rows = slice(p0, p0 + npg)
        shifted = _byte_shift_rows(sec[rows], torch.full((npg,), mb & 3, dtype=i64, device=dev))
        rowsAB0[rows, mb >> 2 : (mb >> 2) + SECW + 1] |= shifted
    rowsA = _byte_shift_rows(rowsAB0, off_meta & 3)
    lenA = (mb_row + sec_bytes + (off_meta & 3) + 3) >> 2

    off_c = starts[a["page0"]]
    rowsC = _byte_shift_rows(a["pfx_words"], off_c & 3)
    lenC = (a["pfx_bytes"] + (off_c & 3) + 3) >> 2

    # head: host part ++ page_bytes ++ [all ans u16 entries][all off u16 entries]
    ep, eb = a["entry_page"], a["entry_batch"]
    vals16 = torch.cat([_pages(plan, a, ans_len)[ep, eb], _pages(plan, a, off_len)[ep, eb]])
    ansoff = vals16[0::2] | (vals16[1::2] << 16)
    head = torch.cat([a["head_host_words"], mb_row + sec_bytes, ansoff])
    F0A, F0C = off_meta >> 2, off_c >> 2
    row_end = torch.maximum((F0A + lenA).max(), (F0C + lenC).max())
    return dict(rowsA=_to_i32(rowsA), F0A=F0A, lenA=lenA, rowsC=_to_i32(rowsC), F0C=F0C, lenC=lenC,
                head_words=_to_i32(head), sizes=torch.stack([body_bytes, row_end]))


# ---------------------------------------------------------------------------
# K7: image stitch
# ---------------------------------------------------------------------------


def image_stitch_plain(rowsA, F0A, lenA, rowsC, F0C, lenC, body_words: int) -> torch.Tensor:
    """Plain version of K7: word w < lenW[r] of row r is ORed into body word
    F0[r] + w, which must lie in the body. rows (R, W) int32, F0 and lenW
    (R,) int64; returns (body_words,) int32. Rows share no payload bits, so
    an index_add_ on int64 words is an OR."""
    out = torch.zeros(body_words, dtype=i64, device=rowsA.device)
    for rows, F0, lenW in ((rowsA, F0A, lenA), (rowsC, F0C, lenC)):
        w = torch.arange(rows.shape[1], device=rows.device)
        ok = w[None, :] < lenW[:, None]
        out.index_add_(0, (F0[:, None] + w[None, :])[ok], (rows.to(i64) & M32)[ok])
    return _to_i32(out)


def image_stitch(rowsA, F0A, lenA, rowsC, F0C, lenC, body_words: int) -> torch.Tensor:
    """K7: the file body from the pre-shifted row streams A and C;
    arguments as image_stitch_plain. A word placed outside the body stops
    the kernel with a device error (run_image checks the rows first)."""
    if rowsA.device.type == "cpu":
        return image_stitch_plain(rowsA, F0A, lenA, rowsC, F0C, lenC, body_words)
    if any(rows.dim() != 2 or F0.shape != (rows.shape[0],) or lenW.shape != F0.shape
           for rows, F0, lenW in ((rowsA, F0A, lenA), (rowsC, F0C, lenC))):
        raise ValueError("image_stitch: argument shapes do not match the rows")
    _check_cuda((rowsA, torch.int32), (F0A, i64), (lenA, i64), (rowsC, torch.int32),
                (F0C, i64), (lenC, i64))
    body = torch.zeros(body_words, dtype=torch.int32, device=rowsA.device)
    kernels.launch_image_stitch(rowsA, F0A, lenA, rowsC, F0C, lenC, body)
    return body


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def run_image(plan: ImagePlan, a: dict):
    """K5 -> glue -> K6 -> prep -> K7 from uploaded arrays. Returns
    (head_words, body_words, head_bytes, body_bytes): both word arrays are
    int32 tensors on the arrays' device. The body is sized from its byte
    count, read back before K7 with the end word of the farthest row, which
    must lie inside it."""
    out = encode_launch(plan.launch, a)
    prep = prepare_image(plan, a, *out)
    del out
    body_bytes, row_end = prep["sizes"].tolist()
    body_words = -(-body_bytes // 4)
    if row_end > body_words:
        raise RuntimeError(f"prep placed a row up to word {row_end} of a {body_words}-word body")
    body = image_stitch(prep["rowsA"], prep["F0A"], prep["lenA"], prep["rowsC"], prep["F0C"],
                        prep["lenC"], body_words)
    return prep["head_words"], body, plan.head_bytes, body_bytes


def file_image_to_bytes(head_words, body_words, head_bytes: int, body_bytes: int) -> bytes:
    hb = head_words.cpu().numpy().view(np.uint8)[:head_bytes]
    bb = body_words.cpu().numpy().view(np.uint8)[:body_bytes]
    return hb.tobytes() + bb.tobytes()


def encode_container_image_device(nums: np.ndarray, config=None, page_n: int = 1024,
                                  chunk_n: int = 1 << 20, device="cuda"):
    """Encode `nums` to a PCT file image on `device` (the GPU unless the
    caller asks for the CPU). Returns (head_words, body_words, head_bytes,
    body_bytes); file_image_to_bytes of it equals container_compress's
    bytes."""
    device = _resolve_device(device)
    plan = plan_image(nums, config, page_n, chunk_n, device)
    return run_image(plan, upload_image(plan, device))


def encode_container_device(nums: np.ndarray, config=None, page_n: int = 1024,
                            chunk_n: int = 1 << 20, device="cuda") -> bytes:
    """Encode `nums` on `device` (the GPU unless the caller asks for the
    CPU) to PCT container bytes equal to container_compress's: the file
    image, read back."""
    return file_image_to_bytes(*encode_container_image_device(nums, config, page_n, chunk_n, device))
