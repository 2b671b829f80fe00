"""The tensor-core forms of chunked-prefill attention and of the fused
backward at head_dim 256.

``ops.flash.kernel_form("paged_prefill", ...)`` sends bf16 q over bf16 pages
at head_dim 64, 128 and 256 (and, since its 8-bit form, bf16 q over int8 /
fp8 pages) to ``csrc/paged_prefill_tc.cu`` when the page size is one its TMA
boxes take (``ops.flash.tc_page_size``), and every other
call to the scalar ``csrc/paged_prefill.cu``; the fused backward's
tensor-core form now covers head_dim 256.  The plain versions mirror the
tensor-core rounding (p as two bf16 terms against the running max of
``TC_KV_TILE`` columns; Z and dS as two bf16 terms).  Here: the choice for
every combination, the mirrored plain versions against the JAX package's
bf16 functions (Pallas kernels in interpret mode on the CPU) within 2e-2,
the bf16 tolerance of the port's other differential tests, and that the
rounding moves the result, so that the option is not dead.
"""

import ast
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops import backward as jbwd
from flashattention_tpu.ops import decode as jd
from flashattention_tpu.ops import flash as jflash
from flashattention_tpu_torch.ops import backward as tbwd
from flashattention_tpu_torch.ops import decode as td
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-2
JBLOCKS = jflash.BlockSizes(128, 128, 128)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
PAGE_SIZES = (4, 8, 12, 16, 24, 32, 64, 96, 128, 256, 512, 1000)


def _tc_page(ps, d):
    tile = {64: 128, 128: 128, 256: 64}[d]
    return ps % 8 == 0 and (tile % ps == 0 or ps % tile == 0)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda t: str(t).split(".")[1])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_prefill_form_selector(dtype, d):
    """bf16 q, a tensor-core head_dim, bf16 or 8-bit pages and a page size
    the tc form's boxes take; scalar otherwise (and without a page size)."""
    for ps, quantized in itertools.product(PAGE_SIZES, (False, True)):
        want = ("tc" if dtype == torch.bfloat16 and d in (64, 128, 256)
                and _tc_page(ps, d) else "scalar")
        got = tflash.kernel_form("paged_prefill", dtype, d, quantized=quantized, page_size=ps)
        assert got == want, (ps, quantized)
    assert tflash.kernel_form("paged_prefill", dtype, d) == "scalar"


@pytest.mark.parametrize("d", [64, 128, 256])
def test_tc_page_size_rule(d):
    """The rule's edges: the engine's 256 and the card tests' 16 are taken,
    a size that is no multiple of 8 or that neither divides the tile nor
    is divided by it is not."""
    assert tflash.tc_page_size(256, d) and tflash.tc_page_size(16, d)
    assert tflash.tc_page_size(8, d) and tflash.tc_page_size(1024, d)
    assert not tflash.tc_page_size(12, d) and not tflash.tc_page_size(4, d)
    assert not tflash.tc_page_size(96, d) and not tflash.tc_page_size(None, d)
    assert not tflash.tc_page_size(0, d)
    assert tflash.tc_page_size(tflash.TC_KV_TILE[d] * 3, d)
    assert not tflash.tc_page_size(256, 32)


def test_backward_form_includes_head_dim_256():
    q = torch.zeros(1, 8, 256, dtype=torch.bfloat16)
    assert tflash.kernel_form("flash_bwd", torch.bfloat16, 256) == "tc"
    assert tbwd.bwd_form(q, True) == "tc"
    assert tbwd.bwd_form(q, False) == "tc"
    assert tbwd.bwd_form(q.float(), True) == "scalar"
    with tflash.scalar_forms():
        assert tbwd.bwd_form(q, True) == "scalar"
        assert tbwd.bwd_form(q, False) == "scalar"
        assert tflash.kernel_form("paged_prefill", torch.bfloat16, 128, page_size=256) == "scalar"


def _pair(x):
    """The same values as a bf16 JAX array and a bf16 torch tensor."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.tensor(np.asarray(j.astype(jnp.float32))).to(torch.bfloat16)


# (name, KVH, G, d, page size, pages per request, chunk, seg, ctx_lens,
# window, softcap, q scale): GQA with seg > chunk and a ctx = 0 request at a
# page below the KV tile; window + softcap (the pad rows of the
# first request past their window); head_dim 256 with a page of two tiles;
# head_dim 128 at the engine's page size, one request.
CASES = [
    ("gqa_seg_ctx0_d64_ps16", 2, 2, 64, 16, 8, 20, 24, [0, 20, 57, 110], None, None, 1.0),
    ("window_cap_d64_ps32", 2, 2, 64, 32, 6, 24, 32, [24, 77, 150, 190], 30, 10.0, 4.0),
    ("window_cap_d256_ps128", 2, 2, 256, 128, 3, 40, 48, [40, 200, 300], 100, 30.0, 4.0),
    ("mha_d128_ps256", 2, 1, 128, 256, 2, 64, 64, [300], None, None, 1.0),
]


def _prefill_inputs(case, seed):
    _, kvh, g, d, ps, pps, _, seg, ctx, _, _, qmul = case
    rng = np.random.default_rng(seed)
    b = len(ctx)
    pool = b * pps + 3
    k = _pair(rng.standard_normal((pool, kvh, ps, d)).astype(np.float32))
    v = _pair(rng.standard_normal((pool, kvh, ps, d)).astype(np.float32))
    q = _pair(rng.standard_normal((b, kvh, g * seg, d)).astype(np.float32) * np.float32(qmul))
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    return q, k, v, table, np.array(ctx, np.int32)


def _prefill_kw(case):
    _, _, _, d, _, _, chunk, seg, _, window, cap, _ = case
    return dict(chunk=chunk, seg=seg, scale=d**-0.5, window=window, logit_softcap=cap)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tc_prefill_matches_jax_bf16(case):
    """The tensor-core form's plain version (what the CPU path runs in
    bf16) against the JAX kernel in interpret mode, on the rows the JAX
    kernel writes (ctx > 0; the chunk's rows, not the pad rows)."""
    (jq, tq), (jk, tk), (jv, tv), table, ctx = _prefill_inputs(case, 1)
    kw = _prefill_kw(case)
    d, ps, seg, chunk = case[3], case[4], case[7], case[6]
    assert tflash.kernel_form("paged_prefill", tq.dtype, d, page_size=ps) == "tc"
    got = td.paged_prefill_attention_batched(tq, tk, tv, torch.from_numpy(table),
                                             torch.from_numpy(ctx), **kw)
    want = np.asarray(jd.paged_prefill_attention_batched(
        jq, jk, jv, jnp.asarray(table), jnp.asarray(ctx), **kw).astype(jnp.float32))
    live = (np.arange(got.shape[2]) % seg) < chunk
    req = ctx > 0
    validate_result(got[torch.from_numpy(req)][:, :, torch.from_numpy(live)],
                    want[req][:, :, live], TOL, name="o")
    for i in np.nonzero(~req)[0]:  # ctx = 0: zeros
        assert torch.count_nonzero(got[i]) == 0


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tc_prefill_rounding_moves_the_result(case):
    """The mirrored rounding is live: the tc form's plain version differs
    from the scalar form's by no more than bf16 rounding; it is the default
    in bf16, and in float32 the scalar one is."""
    (_, tq), (_, tk), (_, tv), table, ctx = _prefill_inputs(case, 2)
    kw = _prefill_kw(case)
    args = (tq, tk, tv, torch.from_numpy(table), torch.from_numpy(ctx))
    tc = td.paged_prefill_attention_plain(*args, form="tc", **kw)
    scalar = td.paged_prefill_attention_plain(*args, form="scalar", **kw)
    gap = float((tc.float() - scalar.float()).abs().max())
    assert 0.0 < gap < TOL
    assert torch.equal(td.paged_prefill_attention_plain(*args, **kw), tc)
    f32 = (tq.float(), tk.float(), tv.float(), *args[3:])
    assert torch.equal(td.paged_prefill_attention_plain(*f32, **kw),
                       td.paged_prefill_attention_plain(*f32, form="scalar", **kw))


def test_tc_prefill_zero_rows_match_the_scalar_form():
    """Rows that see no column (a ctx = 0 request, pad rows whose window
    lies past the context) are zeros in both forms, and only those rows."""
    case = ("pad_rows", 2, 2, 64, 16, 4, 8, 24, [0, 20], 3, None, 1.0)
    (_, tq), (_, tk), (_, tv), table, ctx = _prefill_inputs(case, 3)
    kw = _prefill_kw(case)
    args = (tq, tk, tv, torch.from_numpy(table), torch.from_numpy(ctx))
    tc = td.paged_prefill_attention_plain(*args, form="tc", **kw)
    scalar = td.paged_prefill_attention_plain(*args, form="scalar", **kw)
    zero_tc = (tc == 0).all(-1)
    assert torch.equal(zero_tc, (scalar == 0).all(-1))
    assert bool(zero_tc[0].all())
    # request 1: chunk 8 at ctx 20; a row at pos sees nothing once its
    # window's first column pos - 2 lies past the last one, 19 (both segments)
    pos = 20 - 8 + torch.arange(24)
    assert torch.equal(zero_tc[1, 0], (pos - 3 + 1 > 19).repeat(2))


def test_tc_prefill_is_the_forward_mirror_per_request():
    """The tc plain version of one request is the tensor-core forward's
    plain version over its gathered context, rows at ctx - chunk + r % seg."""
    case = CASES[0]
    (_, tq), (_, tk), (_, tv), table, ctx = _prefill_inputs(case, 4)
    kw = _prefill_kw(case)
    got = td.paged_prefill_attention_plain(tq, tk, tv, torch.from_numpy(table),
                                           torch.from_numpy(ctx), form="tc", **kw)
    i, n = 3, int(ctx[3])
    idx = torch.from_numpy(table[i]).long()
    kvh, ps, d = tk.shape[1:]
    k = tk[idx].transpose(0, 1).reshape(kvh, -1, d)
    v = tv[idx].transpose(0, 1).reshape(kvh, -1, d)
    want = tflash.flash_attention_plain(tq[i], k, v, causal=True, scale=kw["scale"], kv_len=n,
                                        q_offset=n - kw["chunk"], q_seq_len=kw["seg"], form="tc")
    assert torch.equal(got[i], want)


# ── the fused backward at head_dim 256 ──────────────────────────────────────

# (name, BH, G, S per group, window, softcap, q scale)
BWD_CASES = [
    ("window_softcap_g2", 1, 2, 256, 64, 30.0, 8.0),
    ("causal_g1", 2, 1, 128, None, None, 1.0),
]


def _bwd_inputs(case, seed):
    _, bh, g, s, _, _, qmul = case
    rng = np.random.default_rng(seed)

    def rand(shape, mult=1.0):
        x = torch.tensor(rng.standard_normal(shape).astype(np.float32) * np.float32(mult))
        return x.to(torch.bfloat16)

    d = 256
    return (rand((bh, g * s, d), qmul), rand((bh, s, d)), rand((bh, s, d)),
            rand((bh, g * s, d), 0.25 / qmul))


def _bwd_kw(case):
    _, _, g, s, window, cap, _ = case
    return dict(causal=True, scale=256**-0.5, q_seq_len=s if g > 1 else None, window=window,
                logit_softcap=cap)


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_tc_backward_d256_matches_jax_bf16(case):
    """attention_vjp's gradients at head_dim 256, whose CPU backward is the
    tensor-core form's plain version, against JAX's VJP in bf16."""
    q, k, v, do = _bwd_inputs(case, 5)
    kw = _bwd_kw(case)
    assert tbwd.bwd_form(q, True) == "tc"
    targs = [x.clone().requires_grad_() for x in (q, k, v)]
    to = tbwd.attention_vjp(*targs, kw["causal"], kw["scale"], None, None, None, kw["q_seq_len"],
                            kw["window"], kw["logit_softcap"])
    tgrads = torch.autograd.grad(to, targs, do)

    def j_out(q, k, v):
        return jbwd.attention_vjp(q, k, v, kw["causal"], kw["scale"], JBLOCKS, None, True,
                                  kw["q_seq_len"], kw["window"], kw["logit_softcap"])

    jargs = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)]
    jo, jvjp = jax.vjp(j_out, *jargs)
    jgrads = jvjp(jnp.asarray(do.float().numpy(), jnp.bfloat16))
    validate_result(to.detach(), np.asarray(jo, np.float32), TOL, name="o")
    for name, g_, w in zip(("dq", "dk", "dv"), tgrads, jgrads):
        validate_result(g_, np.asarray(w, np.float32), TOL, name=name)


@pytest.mark.parametrize("case", BWD_CASES, ids=[c[0] for c in BWD_CASES])
def test_tc_backward_d256_rounding_moves_the_result(case):
    q, k, v, do = _bwd_inputs(case, 6)
    kw = _bwd_kw(case)
    o, l, m = tflash.flash_attention_plain(q, k, v, save_residuals=True, **kw)
    lse = m + torch.log(l)
    tc = tbwd.flash_attention_bwd_plain(q, k, v, o, lse, do, form="tc", **kw)
    scalar = tbwd.flash_attention_bwd_plain(q, k, v, o, lse, do, form="scalar", **kw)
    gaps = [float((a.float() - b.float()).abs().max()) for a, b in zip(tc, scalar)]
    assert all(0.0 < x < TOL for x in gaps), gaps
    default = tbwd.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(default, tc))


# ── the probe and mutation tools ────────────────────────────────────────────


@pytest.mark.parametrize("script", ["probe_mma.py", "probe_softmax.py", "tc_mutants.py",
                                    "probe_int8.py"])
def test_tensor_core_tools_import_no_jax(script):
    """The tensor-core forms' card scripts drive the port alone."""
    with open(os.path.join(ROOT, "torch_tools", script)) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n and (n.split(".")[0] in ("jax", "jaxlib")
                                           or n.split(".")[0] == "flashattention_tpu")]
