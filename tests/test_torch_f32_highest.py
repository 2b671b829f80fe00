"""Float32 attention at JAX's ``"float32"`` (XLA's HIGHEST) on the port's
tensor-core forms.

The JAX package computes ``precision="float32"`` as XLA's HIGHEST, each
float32 value as three bf16 terms and six products (``flashattention_tpu/
ops/flash.py:40``), and chunked prefill over float32 pools the same way
(``ops/decode.py:438-447``).  The port's flash forward takes that mode, and
``"bf16_3x"`` at d = 256, to ``csrc/flash_fwd_f32.cuh``'s kernel (the
float32 form ``"tc_f32"``, built into ``flash_fwd_tc_f32``), and paged
prefill over float32 pools to the same kernel's paged form
(``paged_prefill_tc_f32``); on the CPU their plain versions mirror the
split.  Here, with numpy inputs from a seed: the flash forward's exact mode
at d = 64 / 128 / 256 (causal, window + softcap, segment ids) and
``"bf16_3x"`` / ``"bf16"`` at d = 256 against the JAX ``flash_attention``
in interpret mode; paged prefill over float32 pools at Gemma-2's features
and at d = 128 MHA against the JAX functions, all within 1e-4 (``"bf16"``:
2e-2); the exact mirror against a float64 oracle on inputs whose third
terms move the output (``probes.lo3_term_f32_qkv``, ``v3_term_f32_qkv``),
below a bound the two-term form and every copy without one third-term
product exceed; and the routes ``kernel_form`` picks.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops import decode as jd
from flashattention_tpu.ops import flash as jflash
from flashattention_tpu_torch.ops import decode as td
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.ops import probes
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bf16_3x": 1e-4, "bf16": 2e-2}
JBLOCKS = jflash.BlockSizes(128, 128, 128)
# The exact mirror against float64 on lo3_term_f32_qkv's inputs, relative to
# the output's magnitude: it misses by the products HIGHEST drops (x2 y3,
# about 5e-6 of it), the two-term form and a copy without one third-term
# product by 1e-3 and more.
ORACLE_BOUND = 1e-4

CASES = {
    "causal": dict(causal=True),
    "window_softcap": dict(causal=True, window=100, logit_softcap=5.0),
    "segments": dict(causal=False, segments=True),
}


def _inputs(seed, d, s=256, bh=2):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32) for _ in range(3))
    seg = tuple(np.sort(rng.integers(0, 3, (bh, s)), -1).astype(np.int32) for _ in range(2))
    return q, k, v, seg


def _both(seed, d, mode, case):
    """The port's and the JAX flash forward on the same inputs."""
    q, k, v, seg = _inputs(seed, d)
    kw = dict(CASES[case], scale=d**-0.5)
    if kw.pop("segments", False):
        kw["q_segment_ids"], kw["kv_segment_ids"] = seg
    want = jflash.flash_attention(*map(jnp.asarray, (q, k, v)), precision=mode, interpret=True,
                                  block_sizes=JBLOCKS,
                                  **{n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
                                     for n, x in kw.items()})
    got = tflash.flash_attention(*map(torch.tensor, (q, k, v)), precision=mode,
                                 **{n: torch.tensor(x) if isinstance(x, np.ndarray) else x
                                    for n, x in kw.items()})
    return got, np.asarray(want)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("d", [64, 128, 256])
def test_exact_mode_matches_jax(d, case):
    assert tflash.kernel_form("flash_fwd", torch.float32, d, precision="float32") == "tc_f32"
    got, want = _both(1, d, "float32", case)
    assert got.dtype == torch.float32
    validate_result(got, want, TOL["float32"])


@pytest.mark.parametrize("case", ["causal", "window_softcap"])
@pytest.mark.parametrize("mode", ["bf16_3x", "bf16"])
def test_d256_two_term_and_one_pass_modes_match_jax(mode, case):
    assert tflash.kernel_form("flash_fwd", torch.float32, 256, precision=mode) == "tc_f32"
    got, want = _both(2, 256, mode, case)
    validate_result(got, want, TOL[mode])


# (name, KVH, G, d, page size, pages per request, chunk, seg, ctx_lens,
# window, softcap): Gemma-2's features (d = 256, G = 2, window, softcap,
# page 256) over two requests of different context, and d = 128 MHA.
PAGED = {
    "gemma2_d256": (2, 2, 256, 256, 3, 64, 64, [520, 300], 128, 50.0),
    "mha_d128": (2, 1, 128, 256, 2, 64, 64, [300], None, None),
}


def _paged_inputs(name, seed):
    kvh, g, d, ps, pps, _, seg, ctx, _, _ = PAGED[name]
    rng = np.random.default_rng(seed)
    b = len(ctx)
    pool = b * pps + 2
    kp, vp = (rng.standard_normal((pool, kvh, ps, d)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((b, kvh, g * seg, d)).astype(np.float32)
    table = rng.permutation(pool)[: b * pps].reshape(b, pps).astype(np.int32)
    return q, kp, vp, table, np.array(ctx, np.int32)


@pytest.mark.parametrize("name", list(PAGED))
def test_paged_prefill_float32_pools_match_jax(name):
    """The batched entry point at Gemma-2's shape, the single-request one
    at d = 128, on the chunk's rows, against the JAX kernels (HIGHEST over
    float32 pools) in interpret mode."""
    kvh, g, d, ps, _, chunk, seg, ctx, window, cap = PAGED[name]
    q, kp, vp, table, ctx_np = _paged_inputs(name, 3)
    kw = dict(chunk=chunk, seg=seg, scale=d**-0.5, window=window, logit_softcap=cap)
    assert tflash.kernel_form("paged_prefill", torch.float32, d, page_size=ps) == "tc_f32"
    tq, tk, tv, tt = map(torch.from_numpy, (q, kp, vp, table))
    jargs = tuple(map(jnp.asarray, (q, kp, vp, table)))
    if len(ctx) > 1:
        got = td.paged_prefill_attention_batched(tq, tk, tv, tt, torch.from_numpy(ctx_np), **kw)
        want = np.asarray(jd.paged_prefill_attention_batched(*jargs, jnp.asarray(ctx_np), **kw))
    else:
        got = td.paged_prefill_attention(tq[0], tk, tv, tt[0], int(ctx[0]), **kw)[None]
        want = np.asarray(jd.paged_prefill_attention(jargs[0][0], *jargs[1:3], jargs[3][0],
                                                     int(ctx[0]), **kw))[None]
    assert got.dtype == torch.float32
    live = (np.arange(got.shape[2]) % seg) < chunk
    validate_result(got[:, :, torch.from_numpy(live)], want[:, :, live], TOL["float32"])


def _pairs_mirror(q, k, v, drop=(), v_terms=3):
    """The "float32" form over S_kv <= one KV tile (no rescale), causal, at
    scale 1: S and PV from the six term products x1 y1, x1 y2, x2 y1, x1 y3,
    x2 y2, x3 y1 summed in float64, less the pairs in ``drop`` (by (left,
    right) term index); ``v_terms`` of V's terms."""
    pairs = [(a, b) for a, b in ((0, 0), (0, 1), (1, 0), (0, 2), (1, 1), (2, 0))
             if (a, b) not in drop]
    qs, ks = tflash._split3_bf16(q), tflash._split3_bf16(k)
    s = sum(torch.einsum("bqd,bkd->bqk", qs[a].double(), ks[b].double()) for a, b in pairs)
    rows, s_kv = s.shape[1:]
    s = torch.where(torch.ones(rows, s_kv, dtype=torch.bool).tril(), s, float("-inf")).float()
    p = torch.exp((s - s.amax(-1, keepdim=True)).double()).float()
    ps, vs = tflash._split3_bf16(p), tflash._split3_bf16(v)
    o = sum(torch.einsum("bqk,bkd->bqd", ps[a].double(), vs[b].double()) for a, b in pairs
            if b < v_terms)
    return (o / p.double().sum(-1, keepdim=True)).float()


def _oracle(q, k, v):
    s = torch.einsum("bqd,bkd->bqk", q.double(), k.double())
    rows, s_kv = s.shape[1:]
    s = torch.where(torch.ones(rows, s_kv, dtype=torch.bool).tril(), s, float("-inf"))
    return torch.softmax(s, -1) @ v.double()


@pytest.mark.parametrize("d", [64, 128, 256])
def test_exact_mirror_against_float64_below_the_two_term_error(d):
    """On lo3_term_f32_qkv's inputs (one KV tile, causal): the port's exact
    plain form equals the six-product mirror, is within ORACLE_BOUND of the
    float64 oracle, and the two-term form and each copy without one
    third-term product (x1 y3, x2 y2, x3 y1) miss by more."""
    tile = tflash.f32_kv_tile(d, "float32")
    q, k, v = probes.lo3_term_f32_qkv(2, tile, d, generator=torch.Generator().manual_seed(6))
    oracle = _oracle(q, k, v)
    norm = float(oracle.abs().max())

    def miss(o):
        return float((o.double() - oracle).abs().max()) / norm

    port = tflash.flash_attention(q, k, v, causal=True, scale=1.0, precision="float32")
    assert float((port - _pairs_mirror(q, k, v)).abs().max()) <= 1e-6 * norm
    exact = miss(port)
    two = miss(tflash.flash_attention(q, k, v, causal=True, scale=1.0, precision="bf16_3x"))
    dropped = {pair: miss(_pairs_mirror(q, k, v, drop=(pair,))) for pair in ((0, 2), (1, 1), (2, 0))}
    print(f"d={d}: exact {exact:.3g}, two-term {two:.3g}, without a third-term product "
          f"{ {f'x{a + 1}y{b + 1}': f'{e:.3g}' for (a, b), e in dropped.items()} }")
    assert exact <= ORACLE_BOUND < two
    for pair, e in dropped.items():
        assert e > ORACLE_BOUND, pair


@pytest.mark.parametrize("d", [64, 128, 256])
def test_exact_mirror_keeps_v_third_term(d):
    """On v3_term_f32_qkv's inputs (each row attends its own key alone) the
    exact plain form returns V's rows to the last bit, the float64 oracle's
    answer, and a copy that drops V's third term misses by more than the
    1e-4 of the card's float32 checks."""
    q, k, v = probes.v3_term_f32_qkv(2, d, generator=torch.Generator().manual_seed(7))
    port = tflash.flash_attention(q, k, v, causal=True, scale=1.0, precision="float32")
    assert torch.equal(port, v)
    assert torch.equal(_oracle(q, k, v).float(), v)
    assert float((_pairs_mirror(q, k, v, v_terms=2) - v).abs().max()) > 1e-4


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_flash_forward_routes(d):
    """Float32 q, k, v at d = 64 / 128 / 256 take the float32 form in every
    mode (None and "auto" too); d = 16 / 32, a block mask, 8-bit K/V and
    scalar_forms keep the scalar kernel, and dropout does but at d = 64 /
    128 in "bf16_3x" and "bf16" (the split-pass form's dropout form).  The
    split-in-shared-memory kernel runs "float32" everywhere and "bf16_3x"
    at 256."""
    f32 = torch.float32
    for mode in (None, "auto", *tflash.PRECISIONS):
        want = "tc_f32" if d in (64, 128, 256) else "scalar"
        assert tflash.kernel_form("flash_fwd", f32, d, precision=mode) == want, mode
        for extra in ("dropout", "block_mask", "quantized"):
            want = ("tc_f32" if extra == "dropout" and d in (64, 128) and mode != "float32"
                    else "scalar")
            assert tflash.kernel_form("flash_fwd", f32, d, precision=mode,
                                      **{extra: True}) == want, (mode, extra)
        with tflash.scalar_forms():
            assert tflash.kernel_form("flash_fwd", f32, d, precision=mode) == "scalar"
    if d >= 64:
        assert tflash.f32_split(d, "float32")
        assert tflash.f32_split(d, "bf16_3x") == (d == 256)
        assert not tflash.f32_split(d, "bf16")
        assert tflash.f32_kv_tile(d, "float32") == {64: 64, 128: 64, 256: 32}[d]


@pytest.mark.parametrize("d,ps", list(itertools.product(
    [16, 32, 64, 128, 256], [8, 12, 16, 24, 32, 48, 64, 96, 128, 256, 512, 1000])))
def test_paged_prefill_routes(d, ps):
    """Float32 pools at d = 64 / 128 / 256 on pages the float32 form's TMA
    boxes take at its own tile (a multiple of 8 that divides 64 rows, 32 at
    d = 256, or that the tile divides): the float32 form; else, and for
    d = 16 / 32, float32 q over 8-bit pages and under scalar_forms, the
    scalar kernel.  Paged decode over float32 pools takes its own float32
    form on the pages its boxes take at its 64-row tile."""
    f32 = torch.float32
    tile = {64: 64, 128: 64, 256: 32}.get(d)
    taken = tile is not None and ps % 8 == 0 and (tile % ps == 0 or ps % tile == 0)
    assert tflash.kernel_form("paged_prefill", f32, d, page_size=ps) == (
        "tc_f32" if taken else "scalar")
    assert tflash.kernel_form("paged_prefill", f32, d, page_size=ps, quantized=True) == "scalar"
    decode = d in (64, 128, 256) and ps % 8 == 0 and (64 % ps == 0 or ps % 64 == 0)
    assert tflash.kernel_form("paged_decode", f32, d, page_size=ps) == (
        "tc_f32" if decode else "scalar")
    with tflash.scalar_forms():
        assert tflash.kernel_form("paged_prefill", f32, d, page_size=ps) == "scalar"
