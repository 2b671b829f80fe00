"""Float32 q over bf16 pages through the three paged entry points.

The JAX kernels take q over 16- and 8-bit pages in bf16
(``flashattention_tpu/ops/decode.py:145-150`` for decode, ``:440-445`` for
prefill) and return q's type (their ``out_shape``, ``:359, :637, :773``).
The port's ``paged_attention``, ``paged_prefill_attention`` and
``paged_prefill_attention_batched`` do the same: q is cast to bf16, the bf16
form runs (the tensor-core form where it takes the call; on the CPU its
plain version), and O comes back in float32.  The tensor-core forms write
that O straight from their float32 sums, so it carries no bf16 rounding;
a call whose bf16 form is scalar stores bf16 and casts it.  Here: each
entry point against the JAX function on the same float32 q and bf16 pages
(the Pallas kernels in interpret mode on the CPU) within 2e-2, the bf16
tolerance of the port's other differential tests; the output float32; the
CPU path the plain version of the bf16 form over q's bf16 values, unrounded
in the tensor-core form and through bf16 in the scalar one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops import decode as jd
from flashattention_tpu_torch.ops import decode as td
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

TOL = 2e-2


def _pages(rng, shape):
    """A bf16 pool as a JAX array and a torch tensor of the same values."""
    j = jnp.asarray(rng.standard_normal(shape).astype(np.float32), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _q(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _bf16_rounded(x):
    return torch.equal(x.to(torch.bfloat16).float(), x)


# (name, KVH, G, draft_k, d, page size, pages per request, lengths, window,
# softcap): tensor-core forms at d = 64 / 128 (a window and softcap, a draft
# form); the scalar form at d = 32 and at a page size the TMA boxes do not
# take.
DECODE_CASES = [
    ("tc_g2_d128_ps256", 2, 2, 1, 128, 256, 2, [1, 255, 300], None, None),
    ("tc_g4_d64_ps16_window_cap", 1, 4, 1, 64, 16, 6, [5, 60, 96], 20, 10.0),
    ("tc_draft_k2_d64", 2, 2, 2, 64, 32, 4, [2, 70, 128], None, None),
    ("scalar_g2_d32", 2, 2, 1, 32, 16, 4, [1, 30, 64], None, None),
    ("scalar_g2_d64_ps12", 1, 2, 1, 64, 12, 6, [7, 40, 72], None, None),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_decode_f32_q_over_bf16_pages(case):
    name, kvh, g, k, d, ps, pps, lens, window, cap = case
    rng = np.random.default_rng(11)
    b, pool = len(lens), len(lens) * pps + 2
    (jk, tk), (jv, tv) = (_pages(rng, (pool, kvh, ps, d)) for _ in range(2))
    jq_, tq = _q(rng, (b, kvh, g * k, d))
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    kw = dict(scale=d**-0.5, draft_k=k, window=window, logit_softcap=cap)
    args = (tk, tv, torch.tensor(lens, dtype=torch.int32), torch.from_numpy(table))
    got = td.paged_attention(tq, *args, **kw)
    assert got.dtype == torch.float32
    want = np.asarray(jd.paged_attention(jq_, jk, jv, jnp.asarray(lens, jnp.int32),
                                         jnp.asarray(table), **kw))
    assert want.dtype == np.float32
    validate_result(got, want, TOL, name="o")
    form = tflash.kernel_form("paged_decode", torch.bfloat16, d, page_size=ps, rows=g * k)
    assert form == name.split("_")[0]
    qb = tq.to(torch.bfloat16)
    if form == "tc":  # from the float32 sums: no bf16 rounding
        assert torch.equal(got, td.paged_attention_plain(qb.float(), *args, form="tc", **kw))
        assert not _bf16_rounded(got)
    else:  # the scalar bf16 kernel's store, cast: bf16's rounding of each element
        assert torch.equal(got, td.paged_attention_plain(qb, *args, **kw).float())
        assert _bf16_rounded(got)
        exact = td.paged_attention_plain(qb.float(), tk.float(), tv.float(), *args[2:],
                                         form="scalar", **kw)
        assert bool(((got - exact).abs() <= 2.0**-8 * exact.abs()).all())
        assert not torch.equal(got, exact)


# (name, KVH, G, d, page size, pages per request, chunk, seg, ctx lens,
# window, softcap)
PREFILL_CASES = [
    ("tc_g2_d64_ps16", 2, 2, 64, 16, 8, 20, 24, [20, 57, 110], None, None),
    ("tc_g1_d128_ps256_window_cap", 1, 1, 128, 256, 2, 64, 64, [64, 300], 50, 20.0),
    ("scalar_g2_d32", 2, 2, 32, 16, 6, 16, 16, [16, 70], None, None),
]


@pytest.mark.parametrize("case", PREFILL_CASES, ids=[c[0] for c in PREFILL_CASES])
def test_prefill_f32_q_over_bf16_pages(case):
    name, kvh, g, d, ps, pps, chunk, seg, ctx, window, cap = case
    rng = np.random.default_rng(12)
    b, pool = len(ctx), len(ctx) * pps + 2
    (jk, tk), (jv, tv) = (_pages(rng, (pool, kvh, ps, d)) for _ in range(2))
    jq_, tq = _q(rng, (b, kvh, g * seg, d))
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    kw = dict(chunk=chunk, seg=seg, scale=d**-0.5, window=window, logit_softcap=cap)
    got = td.paged_prefill_attention_batched(tq, tk, tv, torch.from_numpy(table),
                                             torch.tensor(ctx, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    want = np.asarray(jd.paged_prefill_attention_batched(
        jq_, jk, jv, jnp.asarray(table), jnp.asarray(ctx, jnp.int32), **kw))
    assert want.dtype == np.float32
    live = torch.from_numpy((np.arange(g * seg) % seg) < chunk)
    validate_result(got[:, :, live], want[:, :, live.numpy()], TOL, name="o")
    form = tflash.kernel_form("paged_prefill", torch.bfloat16, d, page_size=ps)
    assert form == name.split("_")[0]
    assert _bf16_rounded(got) == (form == "scalar")
    # One request through paged_prefill_attention: the batched call's row.
    one = td.paged_prefill_attention(tq[1], tk, tv, torch.from_numpy(table[1]), ctx[1], **kw)
    assert one.dtype == torch.float32 and torch.equal(one, got[1])
    want_one = np.asarray(jd.paged_prefill_attention(
        jq_[1], jk, jv, jnp.asarray(table[1]), int(ctx[1]), **kw))
    validate_result(one[:, live], want_one[:, live.numpy()], TOL, name="o")


def test_8bit_route_is_unchanged():
    """Float32 q over int8 pages takes the route of bf16 pages: q cast to
    bf16, the bf16 call's form (here the tensor-core 8-bit form), O in
    float32 from its sums (tests/test_torch_quant_f32q.py holds it to the
    JAX kernels)."""
    rng = np.random.default_rng(13)
    kp, vp = (torch.from_numpy(rng.integers(-127, 128, (6, 2, 16, 64)).astype(np.int8))
              for _ in range(2))
    ks, vs = (torch.from_numpy(rng.uniform(0.005, 0.02, (6, 2, 16)).astype(np.float32))
              for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((2, 2, 2, 64)).astype(np.float32))
    lens, table = torch.tensor([10, 40], dtype=torch.int32), torch.tensor([[0, 1, 2], [3, 4, 5]],
                                                                         dtype=torch.int32)
    kw = dict(k_scales_pages=ks, v_scales_pages=vs, scale=0.125)
    got = td.paged_attention(q, kp, vp, lens, table, **kw)
    assert got.dtype == torch.float32
    assert tflash.kernel_form("paged_decode", torch.bfloat16, 64, quantized=True, page_size=16,
                              rows=2) == "tc"
    qb = q.to(torch.bfloat16).float()
    assert torch.equal(got, td.paged_attention_plain(qb, kp, vp, lens, table, form="tc", **kw))
    assert not _bf16_rounded(got)
