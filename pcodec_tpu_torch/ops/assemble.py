"""Device-side PCT file image: the PyTorch/CUDA counterpart of the JAX
package's `pcodec_tpu/ops/assemble.py`, its single-var and its multi-var
("multi": `_plan_image_multi`, `_multi_glue`, `_prep_multi`) plans in one.

The encode's sections (ops/container_encode.py, K5 and K6) stay on the card
and are stitched there, with the page metas and the container directory,
into the byte-exact `.pct` file image. The head (PCT header + directory) is
dense and word-aligned. The body is the wrapped pco stream: per chunk
[prefix: wrapped header (chunk 0) + chunk meta, host bytes], then per page
[page meta | section bytes], at arbitrary byte offsets.

K6's rows are a page's sections: a chain's when every chunk has one
latent var, else a page's with its vars' sections interleaved batch by
batch at joint cursors (ref: pco/src/wrapped/chunk_compressor.rs:657-693).
K7 (`image_assemble`, csrc/image_stitch.cu) builds both from the launch's
outputs (sections, final tANS states, section lengths) and the page
states, reading a descriptor row a chunk (`image_desc`) that names each
var's chains and page-meta fields: the page offsets
by a scan, the head's words, then every body word once, each from the
sources of the page that holds its first byte. Its plain version
(`image_assemble_plain`) is the JAX package's two steps: `prepare_image`
packs every page into a row [page meta | sections] and every chunk prefix
into a row, each pre-shifted by its destination offset mod 4 bytes (rows
share at most their boundary words, out-of-payload bits are zero), and
`image_stitch_plain` ORs the rows into the body.

    plan_image       training (on the card through
                     device_train.plan_encode_device where it covers the
                     configuration, else container_encode.plan_encode on
                     the host, its sorts on the card), the launch, the chunk
                     prefixes, the head's host part
    upload_image     the launch and K7's tables to the card
    run_image        K5 -> K6 -> K7
    file_image_to_bytes
                     reads the image back as bytes

Entry points: encode_container_image_device (the image on the card) and
encode_container_device (its bytes).

A page meta holds, per var in file order, its delta-state latents (a
consecutive delta's moments, a lookback's window state, conv1's state) and
its 4 final tANS state indices; a trivial var has no chain, writes no body
bits, zero directory entries and zero indices.
"""

import struct
from dataclasses import dataclass
from functools import cached_property
from typing import List

import numpy as np
import torch

from pcodec_tpu_torch.codec import container as ctn
from pcodec_tpu_torch.codec.chunk_config import ChunkConfig
from pcodec_tpu_torch.codec.wrapped import FileCompressor
from pcodec_tpu_torch.dtypes import number_type_from_np
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
from pcodec_tpu_torch.ops.device_train import device_train_supported, plan_encode_device

i64 = torch.int64


@dataclass(frozen=True)
class ImageLayout:
    page_n: int
    n_chunks: int
    pages_per_chunk: tuple  # (n_full, rem_page_len) per chunk
    orders: tuple  # consecutive delta order of the primary per chunk
    sls: tuple  # the primary's ans_size_log per chunk
    ts: tuple  # the primary's real tANS table size per chunk; 0 for a trivial var
    bits: tuple  # the primary's latent bits per chunk
    meta_bytes: tuple  # page meta bytes per chunk
    pfx_bytes: tuple  # chunk prefix bytes per chunk
    # per chunk, per var in file order: (delta-state latents, their bits,
    # ANS size log, real table size or 0)
    var_fields: tuple = ()

    @property
    def n_pages(self):
        return tuple(nf + (1 if rem else 0) for nf, rem in self.pages_per_chunk)

    @property
    def total_pages(self):
        return int(sum(self.n_pages))

    @cached_property
    def state_cols(self) -> int:
        """Columns of the page states: the most delta-state latents a page
        meta holds."""
        return max((sum(f[0] for f in vf) for vf in self.var_fields), default=0)

    @cached_property
    def meta_bits(self) -> tuple:
        """Each chunk's page meta bits."""
        return tuple(sum(ns * sb + 4 * sl for ns, sb, sl, _ in vf) for vf in self.var_fields)

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
        """(page, var, batch) of every directory entry, in file order: per
        page, per var, its real batches."""
        nb = -(-self.page_lens() // BATCH)
        nv = np.asarray([len(vf) for vf in self.var_fields], np.int64)[self.chunk_of_page()]
        pv = np.repeat(np.arange(len(nb), dtype=np.int64), nv)  # a (page, var) each
        var = np.concatenate([np.arange(k, dtype=np.int64) for k in nv])
        n_e = nb[pv]
        pages, vars_ = np.repeat(pv, n_e), np.repeat(var, n_e)
        batches = np.concatenate([np.arange(k, dtype=np.int64) for k in n_e]) if len(n_e) else np.zeros(0, np.int64)
        return pages, vars_, batches


@dataclass
class ImagePlan:
    layout: ImageLayout
    enc: EncodePlan
    launch: EncodeLaunch
    moments: torch.Tensor  # (R, state_cols) int64 (u64 bits): each page's delta states, var after var
    head_host: bytes  # PCT header + chunk_ns + chunk_meta_bytes
    prefixes: List[bytes]  # per chunk; chunk 0's starts with the wrapped header
    head_bytes: int
    row_of_page: np.ndarray  # (R,) int64 K6's row of each page; launch.n_rows for none
    var_chains: np.ndarray  # (R, V) int64 the chain of each page's v-th var; -1 for none

    @property
    def identity(self) -> bool:
        """Page p is K6's row p: no trivial chunk and no padding between chunks."""
        R = len(self.row_of_page)
        return R <= self.launch.n_rows and bool(np.array_equal(self.row_of_page, np.arange(R)))

    @property
    def trained_on(self) -> str:
        return self.enc.trained_on


def _host_states(enc: EncodePlan, lay: ImageLayout) -> np.ndarray:
    """(R, state_cols) uint64: each page's delta states of a host-trained
    plan, var after var, from its chunk's page infos."""
    out = np.zeros((lay.total_pages, lay.state_cols), dtype=np.uint64)
    for ci, (p0, npg) in enumerate(zip(lay.page0_of_chunk(), lay.n_pages)):
        col = 0
        for vj in enc.jobs[ci].vars:
            if vj.n_state:
                out[p0 : p0 + npg, col : col + vj.n_state] = np.stack(
                    [info.per_latent_var.get(vj.key).delta_state for info in enc.jobs[ci].cc.page_infos]
                ).astype(np.uint64)
            col += vj.n_state
    return out


def plan_image(nums: np.ndarray, config=None, page_n: int = 1024, chunk_n: int = 1 << 20,
               device="cuda") -> ImagePlan:
    """Planning of the device file image (the JAX `plan_image` and
    `_plan_image_multi`): training, the launch, and the host-serialized
    bytes. Training runs on `device` through device_train.plan_encode_device
    where device_train_supported covers the number type and configuration
    (`trained_on` "device"; it hands a configuration whose auto delta
    picks lookback to the host), else on the host through
    container_encode.plan_encode, whose sorts run on `device` (`trained_on`
    "host")."""
    if len(nums) == 0:
        raise ValueError("plan_image needs at least one number")
    config = config or ChunkConfig()
    if device_train_supported(number_type_from_np(nums.dtype), config, page_n, chunk_n):
        enc = plan_encode_device(nums, config, page_n, chunk_n, device)
    else:
        enc = plan_encode(nums, config, page_n, chunk_n, device)
    L = build_encode_launch(enc)

    orders, sls, tss, bits, var_fields = [], [], [], [], []
    for job in enc.jobs:
        prim = job.primary
        orders.append(job.order)
        sls.append(prim.sl)
        tss.append(0 if prim.trivial else int(prim.tables[4]))
        bits.append(int(job.cc.meta.mode.primary_latent_type(enc.nt.latent).bits))
        var_fields.append(tuple((vj.n_state, vj.state_bits, vj.sl, 0 if vj.trivial else int(vj.tables[4]))
                                for vj in job.vars))

    w = BitWriter()
    FileCompressor().write_header(w)
    wrapped_hdr = w.to_bytes()
    prefixes = []
    for ci, job in enumerate(enc.jobs):
        mw = BitWriter()
        job.cc.write_meta(mw)
        prefixes.append((wrapped_hdr if ci == 0 else b"") + mw.to_bytes())

    meta_bits = [sum(ns * sb + 4 * sl for ns, sb, sl, _ in vf) for vf in var_fields]
    layout = ImageLayout(
        page_n=page_n, n_chunks=len(enc.chunk_ns),
        pages_per_chunk=tuple((cn // page_n, cn % page_n) for cn in enc.chunk_ns),
        orders=tuple(orders), sls=tuple(sls), ts=tuple(tss), bits=tuple(bits),
        meta_bytes=tuple((mb + 7) // 8 for mb in meta_bits), pfx_bytes=tuple(len(p) for p in prefixes),
        var_fields=tuple(var_fields),
    )
    R = layout.total_pages
    if L.row_chains is None:  # K6's rows are the chains: a chunk's pages are its chains in order
        row_of_page = np.full(R, L.n_chains, dtype=np.int64)
        for p0, npg, c0 in zip(layout.page0_of_chunk(), layout.n_pages, L.chain_start):
            if c0 >= 0:
                row_of_page[p0 : p0 + npg] = c0 + np.arange(npg)
        var_chains = np.where(row_of_page < L.n_chains, row_of_page, -1)[:, None]
    else:
        row_of_page = np.arange(R, dtype=np.int64)
        var_chains = L.row_chains
    if enc.dev is not None:  # the moments stay on the card
        rpc = enc.dev.rows_per_chunk
        page_rows = np.concatenate([ci * rpc + np.arange(npg) for ci, npg in enumerate(layout.n_pages)])
        moments = enc.dev.moments[torch.from_numpy(page_rows).to(enc.dev.moments.device), : layout.state_cols]
    else:
        moments = torch.from_numpy(_host_states(enc, layout).view(np.int64))

    # head: PCT header (dir_bytes is static) + chunk_ns + chunk_meta_bytes;
    # the device appends page_bytes and the u16 ans/off entries (4E bytes)
    E = len(layout.dir_entry_pages()[0])
    dir_bytes = 8 * layout.n_chunks + 4 * R + 4 * E
    header = struct.pack(ctn.HEADER_FMT, ctn.MAGIC, enc.nt.type_byte, 1, 0, page_n, enc.n,
                         layout.n_chunks, dir_bytes)
    cmb = [len(p) for p in prefixes]
    cmb[0] -= len(wrapped_hdr)  # the wrapped header is no part of chunk 0's meta
    head_host = (header + np.asarray(enc.chunk_ns, np.uint32).tobytes()
                 + np.asarray(cmb, np.uint32).tobytes())
    return ImagePlan(layout=layout, enc=enc, launch=L, moments=moments, head_host=head_host, prefixes=prefixes,
                     head_bytes=len(head_host) + 4 * R + 4 * E, row_of_page=row_of_page, var_chains=var_chains)


# K7's descriptor table, a row a chunk, in the order of csrc/image_stitch.cu's
# `enum Col`: its pages (the first and the count), its first row of K6's
# (-1 for none: a single-var chunk without a chain), its vars, its page
# meta's bits and bytes, the chunk prefix's bytes and first word in the run
# of prefix words, the chunk's first directory entry, the batches of a full
# page and of its last page; then per var (up to K6_MAX_VARS, in file order)
# its first chain (-1 for a trivial var, which has no chain), its page
# meta's fields (delta-state latents, their bits, ANS size log, table size)
# and the first column of its states in the page states
VAR_COLS = ("chain0", "n_state", "state_bits", "sl", "ts", "mom_col")
_CHUNK_COLS = ("first_page", "n_pages", "row0", "n_vars", "meta_bits", "meta_bytes", "pfx_bytes", "pfx_word",
               "first_entry", "batches", "last_batches")
IMAGE_COLS = _CHUNK_COLS + tuple(f"{c}_{v}" for v in range(kernels.K6_MAX_VARS) for c in VAR_COLS)


def image_desc(plan: ImagePlan):
    """K7's descriptor rows (n_chunks, len(IMAGE_COLS)) int64 and the chunk
    prefixes as one run of u32 words (uint32), each chunk's from a word
    boundary, zero-padded to it."""
    lay, L = plan.layout, plan.launch
    chain_start = L.chain_start
    nb = lambda ln: -(-ln // BATCH)
    pfx_words = [-(-len(p) // 4) for p in plan.prefixes]
    pfx_word = np.cumsum([0] + pfx_words[:-1])
    entries = [len(vf) * (nf * nb(lay.page_n) + nb(rem)) for vf, (nf, rem) in zip(lay.var_fields,
                                                                                  lay.pages_per_chunk)]
    first_entry = np.cumsum([0] + entries[:-1])
    desc = np.zeros((lay.n_chunks, len(IMAGE_COLS)), np.int64)
    for ci, (p0, npg, (_, rem)) in enumerate(zip(lay.page0_of_chunk(), lay.n_pages, lay.pages_per_chunk)):
        vf = lay.var_fields[ci]
        row0 = chain_start[ci] if L.row_chains is None else p0
        desc[ci, : len(_CHUNK_COLS)] = (p0, npg, row0, len(vf), lay.meta_bits[ci], lay.meta_bytes[ci],
                                        lay.pfx_bytes[ci], pfx_word[ci], first_entry[ci], nb(lay.page_n),
                                        nb(rem) if rem else nb(lay.page_n))
        var_desc = desc[ci, len(_CHUNK_COLS) :].reshape(kernels.K6_MAX_VARS, len(VAR_COLS))
        var_desc[:, 0] = -1  # no chain past the chunk's vars
        col = 0
        for v, (vj, (ns, sb, sl, ts)) in enumerate(zip(plan.enc.jobs[ci].vars, vf)):
            var_desc[v] = (L.var_starts[ci][vj.key], ns, sb, sl, ts, col)
            col += ns
    pfx = np.zeros(4 * sum(pfx_words), np.uint8)
    for w0, p in zip(pfx_word, plan.prefixes):
        pfx[4 * w0 : 4 * w0 + len(p)] = np.frombuffer(p, np.uint8)
    return desc, pfx.view(np.uint32)


def upload_image(plan: ImagePlan, device="cuda") -> dict:
    """The launch arrays and what K7 reads besides the launch's outputs (its
    descriptor rows, the prefix words, the head's host words, the page
    states), on `device`."""
    device = _resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    desc, pfx = image_desc(plan)
    a = upload_launch(plan.launch, device)
    a.update({
        "image_desc": t(desc),
        "image_pfx": t(pfx.view(np.int32)),
        "head_host": t(np.frombuffer(plan.head_host, np.int32).copy()),
        "moments": plan.moments.to(device),
    })
    return a


def upload_prep(plan: ImagePlan, device) -> dict:
    """The layout arrays prepare_image reads besides upload_image's, on
    `device`."""
    lay, L = plan.layout, plan.launch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cofp = lay.chunk_of_page()
    pw = max(1, -(-max(lay.pfx_bytes) // 4))
    pfx = np.zeros((lay.n_chunks, 4 * pw), np.uint8)
    for ci, p in enumerate(plan.prefixes):
        pfx[ci, : len(p)] = np.frombuffer(p, np.uint8)
    ep, ev, eb = lay.dir_entry_pages()
    groups = {}
    for ci, vf in enumerate(lay.var_fields):
        groups.setdefault(tuple(f[:3] for f in vf), []).append(ci)
    V = plan.var_chains.shape[1]
    ts_rows = np.zeros((lay.n_chunks, V), np.int64)
    for ci, vf in enumerate(lay.var_fields):
        ts_rows[ci, : len(vf)] = [f[3] for f in vf]
    pfx_row = np.zeros(lay.total_pages, np.int64)
    pfx_row[lay.page0_of_chunk()] = lay.pfx_bytes
    return {
        "row_of_page": t(plan.row_of_page),
        "var_chains": t(np.where(plan.var_chains >= 0, plan.var_chains, L.n_chains)),
        "ts_rows": t(ts_rows[cofp]),
        "meta_bytes_row": t(np.asarray(lay.meta_bytes, np.int64)[cofp]),
        "pfx_bytes_row": t(pfx_row),
        "page0": t(lay.page0_of_chunk()),
        "pfx_bytes": t(np.asarray(lay.pfx_bytes, np.int64)),
        "pfx_words": t(pfx.view(np.uint32).astype(np.int64)),
        "entry_row": t(plan.row_of_page[ep]),
        "entry_var": t(ev),
        "entry_batch": t(eb),
        "head_host_words": t(np.frombuffer(plan.head_host, np.uint32).astype(np.int64)),
        "meta_groups": {key: t(np.nonzero(np.isin(cofp, cis))[0]) for key, cis in groups.items()},
    }


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


def _pack_meta_group(moments, idxs, fields: tuple, mw: int) -> torch.Tensor:
    """Page metas of one group of chunks: per var in file order its
    (n_state, state_bits, sl) fields: n_state delta states at state_bits
    each (from the next columns of `moments`), then the 4 final tANS state
    indices (idxs[v]) at sl bits."""
    packed, col = [], 0
    for v, (ns, sb, sl) in enumerate(fields):
        packed += [(moments[:, col + k], sb) for k in range(ns)] + [(idxs[v][:, k], sl) for k in range(4)]
        col += ns
    return _pack_meta_fields(packed, idxs[0].shape[0], mw, moments.device)


def _rows(plan: ImagePlan, a: dict, x: torch.Tensor) -> torch.Tensor:
    """Per-page rows of a tensor of K6's rows; zeros for a page without one."""
    R = plan.layout.total_pages
    if plan.identity:
        return x[:R]
    ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return ext[a["row_of_page"]]


def prepare_image(plan: ImagePlan, a: dict, sections, states, ans_len, off_len, total_bits) -> dict:
    """Row streams A and C with their destination words (F0) and lengths
    (lenW), the head words, and `sizes`: the body's byte count and the end
    word of the farthest row, from the launch's outputs (the JAX
    `_prepare_image` and `_core_prep`, and `_multi_glue`'s metas and
    directory for pages of several vars). Rows are int32."""
    lay = plan.layout
    dev = sections.device
    R = lay.total_pages
    tb = _rows(plan, a, total_bits)
    sec = _rows(plan, a, sections).to(i64) & M32
    st_ext = torch.cat([states, states.new_zeros((1, 4))])
    vc, ts_rows = a["var_chains"], a["ts_rows"]
    idxs = [st_ext[vc[:, v]] - ts_rows[:, v : v + 1] for v in range(vc.shape[1])]  # trivial var: 0 - 0
    mom = a["moments"]

    mw = max(1, -(-(max(lay.meta_bits) + 24) // 32))
    if len(a["meta_groups"]) == 1:
        ((fields, _),) = a["meta_groups"].items()
        meta = _pack_meta_group(mom, idxs, fields, mw)
    else:
        meta = torch.zeros((R, mw), dtype=i64, device=dev)
        for fields, sel in a["meta_groups"].items():
            meta.index_copy_(0, sel, _pack_meta_group(mom[sel], [x[sel] for x in idxs], fields, mw))

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
    er, ev, eb = a["entry_row"], a["entry_var"], a["entry_batch"]
    V = vc.shape[1]
    lens = [torch.cat([x.reshape(x.shape[0], V, x.shape[-1]), x.new_zeros((1, V, x.shape[-1]))])
            for x in (ans_len, off_len)]  # (K6's rows + a zero row, V, B)
    vals16 = torch.cat([lens[0][er, ev, eb], lens[1][er, ev, eb]])
    ansoff = vals16[0::2] | (vals16[1::2] << 16)
    head = torch.cat([a["head_host_words"], mb_row + sec_bytes, ansoff])
    F0A, F0C = off_meta >> 2, off_c >> 2
    row_end = torch.maximum((F0A + lenA).max(), (F0C + lenC).max())
    return dict(rowsA=_to_i32(rowsA), F0A=F0A, lenA=lenA, rowsC=_to_i32(rowsC), F0C=F0C, lenC=lenC,
                head_words=_to_i32(head), sizes=torch.stack([body_bytes, row_end]))


# ---------------------------------------------------------------------------
# K7: the file image
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


def image_assemble_plain(plan: ImagePlan, a: dict, sections, states, ans_len, off_len, total_bits):
    """Plain version of K7: prepare_image's row streams, placed by
    image_stitch_plain. Arguments: the plan, upload_image's arrays and the
    launch's outputs (encode_launch). Returns (head_words, body_words)
    int32 tensors and the body's byte count."""
    prep = prepare_image(plan, {**a, **upload_prep(plan, sections.device)}, sections, states, ans_len, off_len,
                         total_bits)
    body_bytes, row_end = prep["sizes"].tolist()
    body_words = -(-body_bytes // 4)
    if row_end > body_words:
        raise RuntimeError(f"prep placed a row up to word {row_end} of a {body_words}-word body")
    body = image_stitch_plain(prep["rowsA"], prep["F0A"], prep["lenA"], prep["rowsC"], prep["F0C"], prep["lenC"],
                              body_words)
    return prep["head_words"], body, body_bytes


def image_assemble(plan: ImagePlan, a: dict, sections, states, ans_len, off_len, total_bits):
    """K7: the file image's head words and body from the launch's outputs;
    arguments and results as image_assemble_plain. Two C calls: the head
    and the page offsets, then (after the body's byte count is read back,
    the one host sync) the body, each word written once."""
    if sections.device.type == "cpu":
        return image_assemble_plain(plan, a, sections, states, ans_len, off_len, total_bits)
    lay, L = plan.layout, plan.launch
    R, dev = lay.total_pages, sections.device
    V = plan.var_chains.shape[1]
    lens_shape = (L.n_rows, -(-L.page_n // BATCH)) if L.row_chains is None else (L.n_rows, V,
                                                                                  -(-L.page_n // BATCH))
    if (sections.shape != (L.n_rows, L.sec_words) or states.shape != (L.n_chains, 4)
            or ans_len.shape != lens_shape or off_len.shape != lens_shape or total_bits.shape != (L.n_rows,)
            or a["moments"].shape[0] != R or a["moments"].shape[1] < lay.state_cols
            or a["image_desc"].shape != (lay.n_chunks, len(IMAGE_COLS))):
        raise ValueError("image_assemble: the launch's outputs do not match the plan")
    _check_cuda((sections, torch.int32), (states, i64), (ans_len, i64), (off_len, i64), (total_bits, i64),
                (a["moments"], i64), (a["image_desc"], i64), (a["image_pfx"], torch.int32),
                (a["head_host"], torch.int32))
    if max(lay.meta_bits) > 64 * 32:
        raise ValueError("image_assemble: K7 packs page metas of at most 64 words")
    n_head = plan.head_bytes // 4
    E = n_head - a["head_host"].shape[0] - R
    head = torch.empty(n_head, dtype=torch.int32, device=dev)
    scan_words, page_words = kernels.image_scratch_sizes(R)
    scan = torch.empty(scan_words, dtype=i64, device=dev)
    pages = torch.empty(page_words, dtype=torch.int32, device=dev)
    kernels.launch_image_offsets(a["image_desc"], total_bits, ans_len, off_len, sections, states, a["moments"],
                                 a["image_pfx"], a["head_host"], E, head, scan, pages)
    body_bytes = int(scan[R + -(-R // kernels.K7_SCAN_PAGES)])
    body = torch.empty(-(-body_bytes // 4), dtype=torch.int32, device=dev)
    kernels.launch_image_stitch(a["image_desc"], pages, scan, sections, states, a["moments"], a["image_pfx"], body,
                                1 if L.row_chains is None else V)
    return head, body, body_bytes


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def run_image(plan: ImagePlan, a: dict):
    """K5 -> K6 -> K7 from uploaded arrays. Returns (head_words,
    body_words, head_bytes, body_bytes): both word arrays are int32 tensors
    on the arrays' device."""
    head, body, body_bytes = image_assemble(plan, a, *encode_launch(plan.launch, a))
    return head, body, plan.head_bytes, body_bytes


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
