"""The port's plain K5 -> glue -> plain K6 against JAX's Pallas encode
kernels (EB `_eb_impl`, EC `_ec_impl`) run in interpret mode on the CPU.

One small launch: 700 i64 numbers at page_n 256 (the input of
tests/test_pallas_encode.py::TestEncodeInterpret::test_smoke_interpret).
JAX runs `_run_launch_device` as its two halves, `_run_launch_eb` and
`_run_launch_ec` with the same cursor glue in between, so that p1 and the
offsets can be compared too; K5's steps in plain torch are held to the
same bits. Every comparison is exact. The file stands
alone so that a worker of its own can run it (interpret mode is slow).
"""

import numpy as np
import torch

import jax.numpy as jnp

import pcodec_tpu.ops.pallas_encode as pe

from pcodec_tpu_torch.ops import container_encode as ce

torch.set_num_threads(1)  # the test workers share the cores: more intra-op threads spin on theirs


def test_plain_encode_matches_jax_pallas_kernels_in_interpret_mode():
    nums = np.cumsum(np.random.default_rng(7).integers(0, 90, 700)).astype(np.int64)
    groups = pe._plan_encode(nums, None, 256, 1 << 20)[4]
    ((schema, jobs, dev_args),) = pe._build_launch_args(groups)
    assert len(jobs) == 1 and schema.has_off

    eb = pe._run_launch_eb(schema, *dev_args)
    p1, fstates, ans_len, off_len = eb[:4]
    offlo = eb[4]
    offhi = eb[5] if schema.off64 else jnp.zeros_like(offlo)
    total = ans_len + off_len
    start = jnp.cumsum(total, axis=1) - total
    curs_cols = jnp.stack([start, start + ans_len], axis=2).reshape(start.shape[0], -1)
    sections = pe._run_launch_ec(schema, curs_cols, p1, eb[4], eb[5] if schema.off64 else None)
    T = np.asarray(p1).shape[0]

    L = ce.enc_launch_from_jax(schema, [np.asarray(x) for x in dev_args])
    a = ce.upload_launch(L, "cpu")
    q1, offsets, states = ce.bin_ans_encode(a["latents"], a["body_n"], a["table_id"], a["states0"],
                                            a["nexts"], a["lowers"], a["t1"], a["t2"])
    q_ans, q_off, curs, total_bits = ce.section_cursors(q1)
    secs, k6_ans, k6_off, k6_total = ce.section_pack(q1, offsets, L.sec_words)

    lo = ce._from_round_layout(np.asarray(offlo)).astype(np.uint32).astype(np.uint64)
    hi = ce._from_round_layout(np.asarray(offhi)).astype(np.uint32).astype(np.uint64)
    assert np.array_equal(q1.numpy(), ce._from_round_layout(np.asarray(p1)))
    assert np.array_equal(offsets.numpy().view(np.uint64), lo | (hi << np.uint64(32)))
    st4 = np.asarray(fstates).reshape(T, 8, 32, 4).transpose(0, 2, 1, 3).reshape(T * 256, 4)
    assert np.array_equal(states.numpy(), st4)
    assert np.array_equal(q_ans.numpy(), np.asarray(ans_len))
    assert np.array_equal(q_off.numpy(), np.asarray(off_len))
    assert np.array_equal(curs.numpy(), np.asarray(curs_cols))
    assert np.array_equal(total_bits.numpy(), np.asarray(start[:, -1] + total[:, -1]))
    assert np.array_equal(secs.numpy(), np.asarray(sections).reshape(T * 256, -1))
    assert torch.equal(k6_ans, q_ans) and torch.equal(k6_off, q_off) and torch.equal(k6_total, total_bits)
    assert int(total_bits.sum()) > 0
    # K5's steps in plain torch (tiles of 8 rounds) give JAX's bits too
    t1, t_off, t_st = ce.bin_ans_encode_tiled_plain(a["latents"], a["body_n"], a["table_id"], a["states0"],
                                                    a["nexts"], a["lowers"], a["t1"], a["t2"])
    assert np.array_equal(t1.numpy(), ce._from_round_layout(np.asarray(p1)))
    assert np.array_equal(t_off.numpy().view(np.uint64), lo | (hi << np.uint64(32)))
    assert np.array_equal(t_st.numpy(), st4)
