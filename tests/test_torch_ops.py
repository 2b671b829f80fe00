"""Differential tests of the port's ops against the JAX package.

The same inputs, made from a seed with numpy, go through the JAX function
(Pallas kernels in interpret mode on the CPU, ``precision="float32"`` where an
exact fp32 side is wanted) and through its ``flashattention_tpu_torch``
counterpart, which on CPU tensors runs the plain PyTorch version of each CUDA
kernel.  Tolerances: 1e-4 in float32 (both sides exact fp32; the gap is
summation order), 2e-2 in bfloat16 (the JAX kernel rounds p to bf16 before
PV, the port's plain version does not).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattention_tpu as fj
import flashattention_tpu_torch as ft
from flashattention_tpu.ops import decode as jdecode
from flashattention_tpu.ops import reference as jref
from flashattention_tpu.ops import sampling as jsampling
from flashattention_tpu_torch.ops import decode as tdecode
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.ops import reference as tref
from flashattention_tpu_torch.ops import sampling as tsampling
from flashattention_tpu_torch.utils.testing import max_abs_err, to_numpy, to_torch, validate_result

torch.set_num_threads(2)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(x, dt):
    return jnp.asarray(x, JDT[dt]), torch.tensor(x).to(TDT[dt])


# ── attention / sdpa ────────────────────────────────────────────────────────

# (layout, B, H, KVH, S_q, S_kv, d, causal, dtype)
ATTN_CASES = [
    ("4d", 2, 2, 2, 40, 40, 32, True, "float32"),
    ("4d", 2, 2, 2, 40, 40, 32, False, "float32"),
    ("4d", 1, 4, 2, 33, 33, 32, True, "float32"),  # GQA, ragged S
    ("4d", 1, 4, 2, 48, 48, 32, True, "bfloat16"),
    ("4d", 1, 2, 2, 24, 57, 32, True, "float32"),  # S_q < S_kv: suffix-aligned
    ("3d", 3, 1, 1, 29, 29, 64, True, "float32"),
    ("3d", 2, 1, 1, 16, 40, 16, False, "bfloat16"),
]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_sdpa_matches_jax(case):
    layout, b, h, hkv, s_q, s_kv, d, causal, dt = case
    if layout == "4d":
        shapes = (b, h, s_q, d), (b, hkv, s_kv, d), (b, hkv, s_kv, d)
    else:
        shapes = (b, s_q, d), (b, s_kv, d), (b, s_kv, d)
    q, k, v = _inputs(ATTN_CASES.index(case), *shapes)
    (qj, qt), (kj, kt), (vj, vt) = _both(q, dt), _both(k, dt), _both(v, dt)
    prec = "float32" if dt == "float32" else None
    want = fj.sdpa(qj, kj, vj, causal=causal, precision=prec)
    got = ft.sdpa(qt, kt, vt, causal=causal)
    assert got.dtype == TDT[dt] and got.shape == qt.shape
    validate_result(to_numpy(got), np.asarray(want, np.float32), TOL[dt], name="o")


@pytest.mark.parametrize("groups", [1, 2])
def test_attention_save_residuals_matches_jax(groups):
    q, k, v = _inputs(groups, (2, 2 * groups, 37, 32), (2, 2, 37, 32), (2, 2, 37, 32))
    want = fj.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True, scale=0.2,
        save_residuals=True, precision="float32",
    )
    got = ft.attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=True, scale=0.2,
        save_residuals=True,
    )
    for name, g, w in zip("olm", got, want):
        assert g.shape == w.shape, name
        validate_result(to_numpy(g), np.asarray(w), 1e-4, name=name)


@pytest.mark.parametrize("kv_len", [1, 19, 45])
def test_attention_kv_len_matches_jax(kv_len):
    q, k, v = _inputs(kv_len, (1, 2, 16, 32), (1, 2, 48, 32), (1, 2, 48, 32))
    kw = dict(causal=True, scale=0.3, kv_len=kv_len, q_offset=kv_len - 1)
    want = fj.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), precision="float32", **kw
    )
    got = ft.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)
    validate_result(to_numpy(got), np.asarray(want), 1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_xla_implementation_is_the_oracle(causal):
    q, k, v = _inputs(7, (1, 4, 20, 32), (1, 2, 20, 32), (1, 2, 20, 32))
    want = fj.attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        implementation="xla", save_residuals=True,
    )
    got = ft.attention(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), causal=causal,
        implementation="xla", save_residuals=True,
    )
    for name, g, w in zip("olm", got, want):
        validate_result(to_numpy(g), np.asarray(w), 1e-5, name=name)


@pytest.mark.parametrize(
    "kw",
    [dict(causal=True), dict(causal=False, kv_len=13), dict(causal=True, q_offset=5)],
    ids=["causal", "kv_len", "q_offset"],
)
def test_reference_with_stats_matches_jax(kw):
    q, k, v = _inputs(3, (3, 11, 16), (3, 17, 16), (3, 17, 16))
    want = jref.attention_reference_with_stats(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=0.25, **kw
    )
    got = tref.attention_reference_with_stats(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), scale=0.25, **kw
    )
    for name, g, w in zip("olm", got, want):
        validate_result(to_numpy(g), np.asarray(w), 1e-5, name=name)
    assert tref.DEFAULT_MASK_VALUE == jref.DEFAULT_MASK_VALUE
    np.testing.assert_array_equal(
        tref.causal_mask(5, 7, q_offset=2).numpy(), np.asarray(jref.causal_mask(5, 7, q_offset=2))
    )


def test_flash_gqa_fold_positions():
    """Row r of a q_seq_len-row segment sits at q_offset + r mod q_seq_len:
    the folded call equals G separate calls."""
    q, k, v = (torch.tensor(x) for x in _inputs(11, (2, 3 * 10, 16), (2, 14, 16), (2, 14, 16)))
    got = tflash.flash_attention(q, k, v, causal=True, q_offset=4, q_seq_len=10)
    for g in range(3):
        rows = slice(10 * g, 10 * (g + 1))
        want = tref.attention_reference(q[:, rows], k, v, causal=True, q_offset=4)
        validate_result(got[:, rows], want, 1e-5)


def test_flash_rejects_bad_block_sizes():
    q = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError):
        tflash.flash_attention(q, q, q, block_sizes=tflash.BlockSizes(128, 128))


# ── paged decode ────────────────────────────────────────────────────────────


def _paged_inputs(seed, b, kvh, g, d, ps, pages, pps, lengths):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kvh, g, d)).astype(np.float32)
    kp = rng.standard_normal((pages, kvh, ps, d)).astype(np.float32)
    vp = rng.standard_normal((pages, kvh, ps, d)).astype(np.float32)
    table = rng.permutation(pages)[: b * pps].reshape(b, pps).astype(np.int32)
    return q, kp, vp, np.asarray(lengths, np.int32), table


# (KVH, G, page_size, pages_per_seq, lengths, dtype): lengths hit 1, page
# edges (ps, ps + 1) and the full table.
PAGED_CASES = [
    (2, 1, 8, 4, [1, 8, 9, 32], "float32"),
    (2, 2, 8, 4, [7, 16, 17, 25], "float32"),
    (1, 4, 16, 3, [1, 16, 48], "float32"),
    (2, 2, 8, 4, [1, 8, 9, 32], "bfloat16"),
]


@pytest.mark.parametrize("case", PAGED_CASES, ids=lambda c: "-".join(map(str, c[:4])) + f"-{c[5]}")
def test_paged_attention_matches_jax(case):
    kvh, g, ps, pps, lengths, dt = case
    b = len(lengths)
    q, kp, vp, lens, table = _paged_inputs(
        sum(lengths), b, kvh, g, 32, ps, b * pps + 3, pps, lengths
    )
    (qj, qt), (kj, kt), (vj, vt) = _both(q, dt), _both(kp, dt), _both(vp, dt)
    want = fj.paged_attention(qj, kj, vj, jnp.asarray(lens), jnp.asarray(table), scale=0.17)
    got = ft.paged_attention(qt, kt, vt, torch.tensor(lens), torch.tensor(table), scale=0.17)
    assert got.dtype == TDT[dt]
    validate_result(to_numpy(got), np.asarray(want, np.float32), TOL[dt])


def test_paged_reference_matches_jax():
    q, kp, vp, lens, table = _paged_inputs(5, 3, 2, 2, 16, 4, 10, 3, [0, 5, 12])
    want = jdecode.paged_attention_reference(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(table), scale=0.5,
    )
    got = tdecode.paged_attention_reference(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp), torch.tensor(lens),
        torch.tensor(table), scale=0.5,
    )
    validate_result(to_numpy(got), np.asarray(want), 1e-5)


def test_paged_attention_length_zero_gives_zeros():
    q, kp, vp, lens, table = _paged_inputs(6, 2, 2, 1, 32, 4, 8, 2, [0, 6])
    got = ft.paged_attention(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp), torch.tensor(lens), torch.tensor(table)
    )
    assert torch.count_nonzero(got[0]) == 0 and torch.count_nonzero(got[1]) > 0


# ── sampling ────────────────────────────────────────────────────────────────


@pytest.mark.parametrize(
    "kw",
    [
        dict(temperature=1.0, top_k=None, top_p=None),
        dict(temperature=0.7, top_k=5, top_p=None),
        dict(temperature=1.3, top_k=None, top_p=0.8),
        dict(temperature=0.9, top_k=20, top_p=0.5),
    ],
    ids=["plain", "top_k", "top_p", "both"],
)
def test_filter_logits_matches_jax(kw):
    (x,) = _inputs(9, (3, 64))
    want = np.asarray(jsampling.filter_logits(jnp.asarray(x), **kw))
    got = tsampling.filter_logits(torch.tensor(x), **kw).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    keep = ~np.isinf(want)
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)


def test_sample_logits_respects_filter_and_seed():
    (x,) = _inputs(10, (4, 50))
    logits = torch.tensor(x)
    kept = ~torch.isinf(tsampling.filter_logits(logits, temperature=1.0, top_k=3, top_p=None))

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return torch.stack([
            tsampling.sample_logits(gen, logits, temperature=1.0, top_k=3, top_p=None)
            for _ in range(20)
        ])

    a = draw(1)
    assert torch.equal(a, draw(1))
    assert bool(kept.gather(1, a.T).all())
    top1 = tsampling.sample_logits(
        torch.Generator().manual_seed(0), logits, temperature=1.0, top_k=1, top_p=None
    )
    assert torch.equal(top1, logits.argmax(-1))


# ── bridge ──────────────────────────────────────────────────────────────────


def test_bf16_bridge_roundtrip():
    (x,) = _inputs(12, (5, 7))
    j = np.asarray(jnp.asarray(x, jnp.bfloat16))  # ml_dtypes.bfloat16
    t = to_torch(j)
    assert t.dtype == torch.bfloat16
    assert torch.equal(t, torch.tensor(x).to(torch.bfloat16))
    np.testing.assert_array_equal(to_numpy(t), j.astype(np.float32))
    assert max_abs_err(t, j) == 0.0


def test_input_factories_and_flops_match_jax():
    from flashattention_tpu.utils import benchit as jbench
    from flashattention_tpu.utils import testing as jtest
    from flashattention_tpu_torch.utils import benchit as tbench
    from flashattention_tpu_torch.utils import testing as ttest

    np.testing.assert_array_equal(
        ttest.make_iota((3, 200)).numpy(), np.asarray(jtest.make_iota((3, 200)))
    )
    np.testing.assert_array_equal(ttest.make_ones((2, 3)).numpy(), np.asarray(jtest.make_ones((2, 3))))
    r = ttest.make_random(torch.Generator().manual_seed(0), (1000,), lo=-2.0, hi=3.0)
    assert float(r.min()) >= -2.0 and float(r.max()) < 3.0 and r.std() > 1.0
    for causal in (False, True):
        assert tbench.attention_flops(8, 300, 500, 64, causal=causal) == jbench.attention_flops(
            8, 300, 500, 64, causal=causal
        )
    b = tbench.bound_ms("NVIDIA H100 80GB HBM3", bytes_moved=3.35e9, flops=989e9, dtype="bfloat16")
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bytes_ms"] and abs(b["ops_ms"] - 1.0) < 1e-9
    with pytest.raises(KeyError):
        tbench.card_peaks("Tesla T4")
