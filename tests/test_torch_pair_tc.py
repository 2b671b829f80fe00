"""The two-pass backward pair's tensor-core forms against the JAX package.

With segment ids (and with ``fused=False``) the backward runs the two-pass
pair in both packages (``flashattention_tpu/ops/backward.py:610-615``).  In
bf16 at head_dim 64, 128 or 256 without a block mask the port's pair takes
its tensor-core forms (``csrc/flash_bwd_dq_tc.cu``, and
``csrc/flash_bwd_tc.cu`` built with ``-DFA_PAIR``), whose plain versions
mirror their rounding (Z and dS fed to the products as two bf16 terms).
Here, on CPU tensors: that route's gradients against the JAX package's
``flash_attention_bwd(fused=False, ...)`` (Pallas kernels in interpret mode)
within 2e-2, the bf16 tolerance of the port's other differential tests,
over segment ids with PAD rows, the GQA fold, head_dim 64 / 128 / 256 with a
window and a softcap, dropout with segment ids and kv_len / q_offset; that
the rounding moves the result, so that the form is live; and that the
segment range tables the kernels skip tiles by never call a pair of tiles
dead that holds an equal id.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from flashattention_tpu.ops import backward as jbwd
from flashattention_tpu.ops import flash as jflash
from flashattention_tpu_torch.ops import backward as tbwd
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.utils.packing import PAD_SEGMENT
from flashattention_tpu_torch.utils.testing import to_numpy, validate_result

torch.set_num_threads(2)

TOL = 2e-2
JBLOCKS = jflash.BlockSizes(128, 128, 128)  # the JAX kernels' tile; S is a multiple

# (name, BH, G, S_q per group, S_kv, d, window, softcap, q scale, kv_len,
# q_offset, segment ids, dropout rate); all causal.
CASES = [
    ("segments_pad_d128", 2, 1, 256, 256, 128, None, None, 1.0, None, 0, True, None),
    ("gqa_segments_d64", 2, 2, 128, 128, 64, None, None, 1.0, None, 0, True, None),
    ("window_softcap_segments_d64", 1, 2, 256, 256, 64, 64, 30.0, 8.0, None, 0, True, None),
    ("window_softcap_d128", 1, 1, 256, 256, 128, 100, 20.0, 8.0, None, 0, False, None),
    ("window_softcap_segments_d256", 1, 2, 128, 128, 256, 64, 30.0, 8.0, None, 0, True, None),
    ("dropout_segments_d128", 2, 2, 128, 128, 128, None, None, 1.0, None, 0, True, 0.2),
    ("kvlen_qoffset_d64", 2, 1, 128, 256, 64, None, None, 1.0, 200, 100, False, None),
]
SEED = 4321


def _segments(bh, s, g):
    """Documents of 40, 60 and 20 tokens in row 0, one of 100 in the others,
    then PAD_SEGMENT to the end: the folded q ids (BH, G*S) and KV ids (BH, S)."""
    ids = np.full((bh, s), PAD_SEGMENT, np.int32)
    ids[:, :100] = 0
    ids[0, 40:100], ids[0, 100:120] = 1, 2
    return np.tile(ids, (1, g)), ids


def _inputs(case, seed=0):
    """bf16-rounded q, k, v, do; o and lse from the port's plain float32
    forward (o rounded to bf16), handed to both sides; the options."""
    _, bh, g, s_q, s_kv, d, window, cap, qmul, kv_len, q_offset, segments, rate = case
    rng = np.random.default_rng(seed)

    def rand(shape, mult=1.0):
        x = torch.tensor(rng.standard_normal(shape).astype(np.float32) * np.float32(mult))
        return x.to(torch.bfloat16).float()

    q, k, v = rand((bh, g * s_q, d), qmul), rand((bh, s_kv, d)), rand((bh, s_kv, d))
    do = rand((bh, g * s_q, d), 0.25 / qmul)
    kw = dict(causal=True, scale=d**-0.5, kv_len=kv_len, q_offset=q_offset,
              q_seq_len=s_q if g > 1 else None, window=window, logit_softcap=cap)
    if rate is not None:
        kw.update(dropout_rate=rate, dropout_seed=SEED)
    seg = [torch.tensor(x) for x in _segments(bh, s_q, g)] if segments else [None, None]
    o, l, m = tflash.flash_attention_plain(q, k, v, save_residuals=True, q_segment_ids=seg[0],
                                           kv_segment_ids=seg[1], **kw)
    o = o.to(torch.bfloat16).float()
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    return (q, k, v, o, lse, do), seg, kw


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tc_pair_matches_jax_bf16(case):
    arrays, seg, kw = _inputs(case, 1)
    targs = [x.to(torch.bfloat16) for x in arrays]
    targs[4] = arrays[4]  # lse stays float32
    assert tbwd.bwd_form(targs[0], False) == "tc"
    got = tbwd.flash_attention_bwd(*targs, fused=False, q_segment_ids=seg[0],
                                   kv_segment_ids=seg[1], **kw)
    jargs = [jnp.asarray(to_numpy(x), jnp.bfloat16) for x in arrays]
    jargs[4] = jnp.asarray(to_numpy(arrays[4]), jnp.float32)
    jseg = [None if x is None else jnp.asarray(x.numpy()) for x in seg]
    want = jbwd.flash_attention_bwd(*jargs, block_sizes=JBLOCKS, interpret=True, fused=False,
                                    q_segment_ids=jseg[0], kv_segment_ids=jseg[1], **kw)
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == torch.bfloat16
        validate_result(g_, np.asarray(w, np.float32), TOL, name=name)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[5]], ids=lambda c: c[0])
def test_tc_rounding_moves_the_pair(case):
    """The pair's route on bf16 tensors is its tensor-core form's plain
    version (each kernel of the pair too), whose gradients differ from the
    scalar form's by no more than bf16 rounding."""
    arrays, seg, kw = _inputs(case, 2)
    q, k, v, o, lse, do = (x if i == 4 else x.to(torch.bfloat16) for i, x in enumerate(arrays))
    segs = dict(q_segment_ids=seg[0], kv_segment_ids=seg[1])
    tc = tbwd.flash_attention_bwd_plain(q, k, v, o, lse, do, form="tc", **segs, **kw)
    scalar = tbwd.flash_attention_bwd_plain(q, k, v, o, lse, do, form="scalar", **segs, **kw)
    gaps = [float((a.float() - b.float()).abs().max()) for a, b in zip(tc, scalar)]
    assert all(0.0 < x < TOL for x in gaps), gaps
    route = tbwd.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **segs, **kw)
    assert all(torch.equal(a, b) for a, b in zip(route, tc))
    di = (o.float() * do.float()).sum(dim=-1)
    opts = {n: x for n, x in kw.items() if n != "q_seq_len"}
    opts["q_seq_len"] = kw["q_seq_len"] or q.shape[1]
    sid = dict(q_segment_ids=None if seg[0] is None else seg[0].int(),
               kv_segment_ids=None if seg[1] is None else seg[1].int())
    assert torch.equal(tbwd.dq_kernel(q, k, v, do, lse, di, **sid, **opts), tc[0])
    dk, dv = tbwd.dkv_kernel(q, k, v, do, lse, di, **sid, **opts)
    assert torch.equal(dk, tc[1]) and torch.equal(dv, tc[2])
    with tflash.scalar_forms():
        assert all(torch.equal(a, b) for a, b in zip(
            tbwd.flash_attention_bwd(q, k, v, o, lse, do, fused=False, **segs, **kw), scalar))


def test_seg_tile_ranges_of_a_known_row():
    ids = torch.tensor([[0] * 64 + [1] * 30 + [PAD_SEGMENT] * 40 + [2] * 6])  # 140 rows
    got = tbwd.seg_tile_ranges(ids)
    assert got.dtype == torch.int32
    assert got.tolist() == [[[0, 0], [PAD_SEGMENT, 1], [PAD_SEGMENT, 2]]]


# Ids as runs (documents) of random ids, unsorted, PAD among them: tiles of
# one or a few runs, so that many pairs of tiles are disjoint.
_IDS = st.lists(st.tuples(st.integers(PAD_SEGMENT, 6), st.integers(1, 40)), min_size=1,
                max_size=20).map(lambda runs: [i for i, n in runs for _ in range(n)])


@settings(max_examples=200, deadline=None, database=None)
@given(q_ids=st.lists(_IDS, min_size=1, max_size=3), kv_ids=_IDS,
       tile=st.sampled_from([8, 16, tbwd.SEG_TILE]))
def test_range_tables_never_skip_an_equal_id(q_ids, kv_ids, tile):
    """Random ids, unsorted and with PAD: wherever the tables call a pair of
    tiles dead (ranges disjoint, the kernels' ``fa_bwd::seg_meet``), no id
    of the query tile equals one of the key tile's, and each range is its
    tile's smallest and largest id.  Each head has its own query ids over
    the same key ids."""
    n_q = max(len(x) for x in q_ids)
    qs = torch.tensor([(x * n_q)[:n_q] for x in q_ids], dtype=torch.int32)
    ks = torch.tensor([kv_ids] * len(q_ids), dtype=torch.int32)
    q_rng, kv_rng = tbwd.seg_tile_ranges(qs, tile), tbwd.seg_tile_ranges(ks, tile)
    assert q_rng.shape == (len(q_ids), -(-n_q // tile), 2)
    # The kernels' test (fa_bwd::seg_meet): the two ranges overlap.
    meet = ((q_rng[:, :, None, 0] <= kv_rng[:, None, :, 1])
            & (kv_rng[:, None, :, 0] <= q_rng[:, :, None, 1]))
    for b in range(len(q_ids)):
        for i in range(q_rng.shape[1]):
            qt = set(qs[b, i * tile:(i + 1) * tile].tolist())
            assert q_rng[b, i].tolist() == [min(qt), max(qt)]
            for j in range(kv_rng.shape[1]):
                kt = set(ks[b, j * tile:(j + 1) * tile].tolist())
                assert kv_rng[b, j].tolist() == [min(kt), max(kt)]
                if not meet[b, i, j]:
                    assert not qt & kt, (b, i, j)
