"""The JAX precision modes in the port's float32 two-pass backward pair.

The JAX package's float32 backward takes its two-pass pair (``_dq_kernel``,
``_dkv_kernel``) with segment ids or ``fused=False``
(``flashattention_tpu/ops/backward.py:609-614``), in ``"bf16_3x"`` by
default (:573).  At ``2 d <= 128`` lanes that pair is lane-packed (:713-729):
q, k, v and dO stream as ``[hi | lo]`` bf16 rows and each of its products
(``_packed_nt`` for S and dP, ``_packed_fold`` for dV, dK and dQ, :57-93) is
``hi hi + hi lo + lo hi + lo lo``, four products; at d = 128 and 256 each is
``_dot_g``'s three, ``hi hi + hi lo + lo hi`` (flash.py:149-181).  The
port's pair computes the same in its float32 forms (``kernel_form``
``"tc_f32"``: ``csrc/flash_bwd_dq_tc.cu`` and ``csrc/flash_bwd_tc.cu`` built
with ``-DFA_F32``) at head_dim 64, 128 and 256; on the CPU its plain version
mirrors them.

Here, with numpy inputs from a seed, against the JAX pair in interpret mode
(both fed the same o and lse): the routes; the pair in ``"bf16_3x"`` and
``"bf16"`` over packed documents, packed documents with the GQA fold,
kv_len with q_offset, a window with a softcap over documents, dropout over
documents and ``fused=False`` without segment ids; on inputs where the lo lo
products move S and dP by exact multiples of their float32 step
(``ops.probes.lolo_term_f32_qkvdo``), that the JAX pair keeps them at d = 64
and not at d = 128 or 256, as the port does; and float32 gradients of
``attention()`` over packed documents under autograd against ``jax.grad``.

Tolerances, held on the norm as ``tests/test_torch_bwd_f32.py`` holds the
fused form (see there why not elementwise): each gradient within NORM_TOL
of JAX's in ``||got - want|| / ||want||``, each element within ELEM_TOL of
the gradient's largest magnitude.  Over 8 seeds of these cases (144
gradients a head_dim) the port sat at most 1.67e-6 (d = 64), 1.50e-6 (d
= 128) and 2.06e-6 (d = 256) from JAX's "bf16_3x", one element at most
8.7e-6 of its gradient's largest magnitude; the exact route at least
4.27e-6 (d = 64), 5.43e-6 (d = 128) and 5.50e-6 (d = 256), three products
at d = 64 at least 4.14e-6, four at d = 128 at least 4.34e-6 and at d =
256 at least 4.26e-6.  So NORM_TOL = 3e-6 tells the mode's product count
from the exact route and from the other count, which the tests assert on
the same inputs.  ``"bf16"`` (one bf16 product;
JAX's interpret mode computes its DEFAULT products in float32 on the CPU)
within 2e-2 of the largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattention_tpu as fj
import flashattention_tpu_torch as ft
from flashattention_tpu.ops import backward as jbwd
from flashattention_tpu.ops import flash as jflash
from flashattention_tpu_torch.ops import backward as tbwd
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.ops import probes

torch.set_num_threads(2)

JBLOCKS = jflash.BlockSizes(128, 128, 128)
NORM_TOL = 3e-6  # "bf16_3x": ||got - want|| / ||want||, per gradient
ELEM_TOL = 2e-5  # "bf16_3x": max |got - want| / max |want|, per gradient
BF16_TOL = 2e-2  # "bf16": max |got - want| / max |want|
LOLO_TOL = 1e-4  # lo lo inputs: ||got - want|| / ||want||; the other count misses by 2.5e-3+
SEED = 1234
DOCS = (70, 100, 86)  # packed documents of a 256-token row

# (BH, G, S_q per group, S_kv, whether segment ids, kwargs): folded q (BH,
# G S_q, d); all go to the pair (segment ids, else fused=False).
CASES = {
    "segments": (2, 1, 256, 256, True, dict(causal=True)),
    "segments_gqa": (2, 2, 128, 128, True, dict(causal=True)),
    "kv_len_q_offset": (2, 1, 128, 256, False, dict(causal=True, kv_len=200, q_offset=100)),
    "window_softcap_segments": (2, 1, 256, 256, True,
                                dict(causal=True, window=100, logit_softcap=5.0)),
    "dropout_segments": (2, 1, 256, 256, True,
                         dict(causal=True, dropout_rate=0.1, dropout_seed=SEED)),
    "unfused": (2, 1, 256, 256, False, dict(causal=True)),
}


def _docs(n):
    """Segment ids of ``n`` tokens packed from DOCS (cut at n)."""
    return np.repeat(np.arange(len(DOCS), dtype=np.int32), DOCS)[:n]


def _case(case, d, seed=0):
    """numpy q, k, v, dO of a case, its folded segment ids (or None) and
    keywords (``q_seq_len`` with the GQA fold)."""
    bh, g, s_q, s_kv, segments, kw = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, g * s_q, d)).astype(np.float32)
    k, v = (rng.standard_normal((bh, s_kv, d)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal(q.shape).astype(np.float32)
    kw = dict(kw, scale=d**-0.5)
    if g > 1:
        kw["q_seq_len"] = s_q
    segs = None
    if segments:
        ids = _docs(s_q)
        segs = (np.tile(ids, (bh, g)), np.tile(ids, (bh, 1)))
    return q, k, v, do, segs, kw


def _rel(got, want):
    """(norm, elementwise) error of ``got`` against ``want``, each over
    ``want``'s."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = got - want
    return (float(np.linalg.norm(diff) / np.linalg.norm(want)),
            float(np.abs(diff).max() / np.abs(want).max()))


def _pair(case, d, mode, seed=0):
    """The port's pair in ``mode`` and the JAX pair in ``mode`` (interpret
    mode), from the same o and lse (the port's exact plain forward), and
    the port's exact route (``precision="float32"``): ``(got, exact,
    want)``, numpy."""
    q, k, v, do, segs, kw = _case(case, d, seed)
    tsegs = {} if segs is None else dict(zip(("q_segment_ids", "kv_segment_ids"),
                                             map(torch.tensor, segs)))
    o, l, m = tflash.flash_attention_plain(*map(torch.tensor, (q, k, v)), save_residuals=True,
                                           form="scalar", **tsegs, **kw)
    lse = (m + torch.log(torch.where(l == 0, 1.0, l))).numpy()
    arrays = (q, k, v, o.numpy(), lse, do)
    jsegs = {n: jnp.asarray(x.numpy()) for n, x in tsegs.items()}
    want = jbwd.flash_attention_bwd(*map(jnp.asarray, arrays), block_sizes=JBLOCKS,
                                    precision=mode, interpret=True, fused=False, **jsegs, **kw)
    t = [torch.tensor(x) for x in arrays]
    got = tbwd.flash_attention_bwd(*t, fused=False, precision=mode, **tsegs, **kw)
    exact = tbwd.flash_attention_bwd(*t, fused=False, precision="float32", **tsegs, **kw)
    return ([x.numpy() for x in got], [x.numpy() for x in exact],
            [np.asarray(x, np.float32) for x in want])


def _other_count(case, d, monkeypatch):
    """The port's plain pair in "bf16_3x" with the other product count:
    three at d = 64, four at d = 128 and 256."""
    other = tbwd._dot3 if d == 64 else tbwd._dot4
    monkeypatch.setattr(tbwd, "_dot3", other)
    monkeypatch.setattr(tbwd, "_dot4", other)
    got, _, _ = _pair(case, d, "bf16_3x")
    monkeypatch.undo()
    return got


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_routes(d):
    """The pair's float32 forms at d = 64, 128 and 256 in "bf16_3x" (the
    default) and "bf16", dropout or not; "float32", the other head_dims, a
    block mask and scalar_forms keep the exact scalar pair."""
    f32 = torch.float32
    q = torch.zeros(1, 8, d)
    for mode in (None, "auto", *tflash.PRECISIONS):
        want = "tc_f32" if d in (64, 128, 256) and mode != "float32" else "scalar"
        for kernel in ("flash_bwd_dq", "flash_bwd_dkv"):
            assert tflash.kernel_form(kernel, f32, d, precision=mode) == want, (kernel, mode)
            assert tflash.kernel_form(kernel, f32, d, precision=mode, dropout=True) == want
            assert tflash.kernel_form(kernel, f32, d, precision=mode, block_mask=True) == "scalar"
        assert tbwd.bwd_form(q, False, precision=mode) == want
        assert tbwd.bwd_form(q, False, True, precision=mode) == "scalar"
        with tflash.scalar_forms():
            assert tbwd.bwd_form(q, False, precision=mode) == "scalar"


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", list(CASES))
def test_bf16_3x_pair_matches_jax(d, case, monkeypatch):
    """Each gradient within NORM_TOL of JAX's "bf16_3x" pair in norm and
    ELEM_TOL elementwise: four products at d = 64, three at d = 128 and 256.  The
    exact route and the other product count each miss NORM_TOL on the same
    inputs."""
    assert tbwd.bwd_form(torch.zeros(1, 8, d), False) == "tc_f32"
    got, exact, want = _pair(case, d, "bf16_3x")
    other = _other_count(case, d, monkeypatch)
    for name, a, e, o, w in zip(("dq", "dk", "dv"), got, exact, other, want):
        (norm, elem), (exact_norm, _), (other_norm, _) = _rel(a, w), _rel(e, w), _rel(o, w)
        print(f"d={d} {case} {name}: bf16_3x {norm:.3g} (max {elem:.3g}), exact "
              f"{exact_norm:.3g}, other count {other_norm:.3g}")
        assert a.dtype == np.float32
        assert norm <= NORM_TOL, name
        assert elem <= ELEM_TOL, name
        assert exact_norm > NORM_TOL, name
        assert other_norm > NORM_TOL, name


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("case", ["segments_gqa", "dropout_segments", "unfused"])
def test_bf16_pair_matches_jax(d, case):
    """The one-pass "bf16" mode (q, k, v and dO rounded to bf16 once)
    within BF16_TOL of JAX's, and not the exact route."""
    got, exact, want = _pair(case, d, "bf16")
    for name, a, e, w in zip(("dq", "dk", "dv"), got, exact, want):
        _, elem = _rel(a, w)
        print(f"d={d} {case} {name}: bf16 {elem:.3g}")
        assert elem <= BF16_TOL, name
        assert _rel(a, e)[1] > 1e-4, name


@pytest.mark.parametrize("d", [64, 128, 256])
def test_lolo_terms_follow_jax(d, monkeypatch):
    """On ``probes.lolo_term_f32_qkvdo``'s inputs lo lo moves every
    gradient by 2.5e-3 to 5e-2 of its norm (measured: dQ, a small
    difference of large products, 0.9-3.4e-6 from JAX's, dK and dV below
    1e-7): the port's pair within LOLO_TOL of JAX's "bf16_3x" pair, the
    other product count more than ten times LOLO_TOL from it."""
    q, k, v, do = probes.lolo_term_f32_qkvdo(2, 256, d, generator=torch.Generator().manual_seed(3))
    kw = dict(causal=True, scale=1.0)
    o, l, m = tflash.flash_attention_plain(q, k, v, save_residuals=True, form="scalar", **kw)
    arrays = [x.numpy() for x in (q, k, v, o, m + torch.log(l), do)]
    want = jbwd.flash_attention_bwd(*map(jnp.asarray, arrays), block_sizes=JBLOCKS,
                                    precision="bf16_3x", interpret=True, fused=False, **kw)
    t = [torch.tensor(x) for x in arrays]
    got = tbwd.flash_attention_bwd(*t, fused=False, **kw)
    other = tbwd._dot3 if d == 64 else tbwd._dot4
    monkeypatch.setattr(tbwd, "_dot3", other)
    monkeypatch.setattr(tbwd, "_dot4", other)
    miss = tbwd.flash_attention_bwd(*t, fused=False, **kw)
    for name, a, o_, w in zip(("dq", "dk", "dv"), got, miss, want):
        norm, other_norm = _rel(a.numpy(), w)[0], _rel(o_.numpy(), w)[0]
        print(f"d={d} {name}: {norm:.3g}, other count {other_norm:.3g}")
        assert norm <= LOLO_TOL, name
        assert other_norm > 10 * LOLO_TOL, name


@pytest.mark.parametrize("d", [64, 128, 256])
def test_each_kernel_of_the_pair_on_its_own(d):
    """dq_kernel and dkv_kernel called on their own (each splitting its own
    inputs) give flash_attention_bwd's pair gradients in the default mode."""
    q, k, v, do, segs, kw = _case("segments_gqa", d, seed=3)
    tq, tk, tv, tdo = map(torch.tensor, (q, k, v, do))
    tsegs = dict(zip(("q_segment_ids", "kv_segment_ids"), map(torch.tensor, segs)))
    o, l, m = tflash.flash_attention(tq, tk, tv, save_residuals=True, **tsegs, **kw)
    lse = m + torch.log(torch.where(l == 0, 1.0, l))
    di = (o * tdo).sum(dim=-1)
    whole = tbwd.flash_attention_bwd(tq, tk, tv, o, lse, tdo, **tsegs, **kw)
    dq = tbwd.dq_kernel(tq, tk, tv, tdo, lse, di, **tsegs, **kw)
    dk, dv = tbwd.dkv_kernel(tq, tk, tv, tdo, lse, di, **tsegs, **kw)
    for a, b in zip((dq, dk, dv), whole):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_attention_grads_over_documents_match_jax_default(d):
    """float32 GQA attention() over packed documents under autograd at the
    default precision (the pair's float32 forms) against ``jax.grad``
    through the JAX attention at its default "bf16_3x": each gradient
    within NORM_TOL in norm and ELEM_TOL elementwise."""
    rng = np.random.default_rng(7 + d)
    q = rng.standard_normal((1, 4, 256, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, 2, 256, d)).astype(np.float32) for _ in range(2))
    t = rng.standard_normal(q.shape).astype(np.float32)
    ids = _docs(256)[None]
    kw = dict(causal=True, scale=d**-0.5)

    def loss(q, k, v):
        return jnp.sum(fj.attention(q, k, v, interpret=True, block_sizes=JBLOCKS,
                                    q_segment_ids=jnp.asarray(ids), kv_segment_ids=jnp.asarray(ids),
                                    **kw) * t)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk_, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (ft.attention(tq, tk_, tv, q_segment_ids=torch.tensor(ids), kv_segment_ids=torch.tensor(ids),
                  **kw) * torch.tensor(t)).sum().backward()
    for name, a, b in zip(("dq", "dk", "dv"), (tq.grad, tk_.grad, tv.grad), jgrads):
        norm, elem = _rel(a.numpy(), b)
        print(f"d={d} {name}: {norm:.3g} (max {elem:.3g})")
        assert norm <= NORM_TOL, name
        assert elem <= ELEM_TOL, name
