"""The tensor-core forms of the port's flash forward and fused backward.

``ops.flash.kernel_form`` picks, for every call, the kernel form that runs
on the card: the tensor-core kernels (``csrc/flash_fwd_tc.cu``,
``csrc/flash_bwd_tc.cu``) for bf16 at their head_dims with 16-bit K/V and
no block mask, the scalar kernels otherwise.  The plain versions mirror the
chosen form's rounding (p, and in the backward Z and dS, fed to their
products as two bf16 terms; the forward's p against the online softmax's
running max over ``TC_KV_TILE`` columns).  The forward's tensor-core form
also takes 8-bit K/V (``tests/test_torch_quant_tc.py``).  Here: the choice for every combination, the
mirrored plain forward and backward against the JAX package's bf16
functions (Pallas kernels in interpret mode on the CPU) within 2e-2, the
bf16 tolerance of the port's other differential tests, and that the
rounding moves the result, so that the option is not dead.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu.ops import backward as jbwd
from flashattention_tpu.ops import flash as jflash
from flashattention_tpu_torch.ops import backward as tbwd
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

TOL = 2e-2
JBLOCKS = jflash.BlockSizes(128, 128, 128)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _expected(kernel, dtype, d, quantized, block_mask):
    """bf16 q at the form's head_dims without a block mask (the fused
    backward and both kernels of the two-pass pair at the forward's); 8-bit
    K/V only in the forward (no backward takes them)."""
    dims = (64, 128, 256) if kernel in ("flash_fwd", "flash_bwd", "flash_bwd_dq",
                                        "flash_bwd_dkv") else ()
    ok = (dtype == torch.bfloat16 and d in dims and not block_mask
          and (not quantized or kernel == "flash_fwd"))
    return "tc" if ok else "scalar"


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv"])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda t: str(t).split(".")[1])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_form_selector(kernel, dtype, d):
    for quantized, block_mask in itertools.product((False, True), repeat=2):
        got = tflash.kernel_form(kernel, dtype, d, quantized=quantized, block_mask=block_mask)
        assert got == _expected(kernel, dtype, d, quantized, block_mask), (quantized, block_mask)


def test_scalar_forms_overrides_the_choice():
    q = torch.zeros(1, 8, 128, dtype=torch.bfloat16)
    with tflash.scalar_forms():
        assert tflash.kernel_form("flash_fwd", torch.bfloat16, 128) == "scalar"
        assert tbwd.bwd_form(q, True) == "scalar"
    assert tflash.kernel_form("flash_fwd", torch.bfloat16, 128) == "tc"


def test_backward_form_follows_the_pass():
    """The fused backward and the two-pass pair (segment ids) take the
    selector's form; the pair with a block mask is scalar only."""
    q = torch.zeros(1, 8, 128, dtype=torch.bfloat16)
    assert tbwd.bwd_form(q, True) == "tc"
    assert tbwd.bwd_form(q, False) == "tc"
    assert tbwd.bwd_form(q, False, block_mask=True) == "scalar"
    assert tbwd.bwd_form(q.float(), True) == "scalar"
    assert tbwd.bwd_form(q.float(), False) == "scalar"
    assert tbwd.bwd_form(torch.zeros(1, 8, 256, dtype=torch.bfloat16), True) == "tc"
    assert tbwd.bwd_form(torch.zeros(1, 8, 32, dtype=torch.bfloat16), True) == "scalar"


# (name, BH, G, S per group, d, causal, window, softcap, q scale, kv_len);
# S a multiple of the JAX kernel's 128-row blocks.
CASES = [
    ("causal_d64", 2, 1, 256, 64, True, None, None, 1.0, None),
    ("gqa_d128", 1, 2, 128, 128, True, None, None, 1.0, None),
    ("window_softcap_d128", 1, 2, 256, 128, True, 64, 30.0, 8.0, None),
    ("noncausal_kvlen_d64", 2, 1, 256, 64, False, None, None, 1.0, 150),
]


def _inputs(case, seed):
    _, bh, g, s, d, _, _, _, qmul, _ = case
    rng = np.random.default_rng(seed)

    def rand(shape, mult=1.0):
        x = torch.tensor(rng.standard_normal(shape).astype(np.float32) * np.float32(mult))
        return x.to(torch.bfloat16)

    return (rand((bh, g * s, d), qmul), rand((bh, s, d)), rand((bh, s, d)),
            rand((bh, g * s, d), 0.25 / qmul))


def _kw(case):
    _, _, g, s, d, causal, window, cap, _, kv_len = case
    return dict(causal=causal, scale=d**-0.5, q_seq_len=s if g > 1 else None, window=window,
                logit_softcap=cap, kv_len=kv_len)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tc_forward_matches_jax_bf16(case):
    q, k, v, _ = _inputs(case, 1)
    kw = _kw(case)
    assert tflash.kernel_form("flash_fwd", q.dtype, q.shape[2]) == "tc"
    got = tflash.flash_attention(q, k, v, **kw)
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v))
    want = jflash.flash_attention(jq, jk, jv, causal=kw["causal"], scale=kw["scale"],
                                  block_sizes=JBLOCKS, interpret=True, q_seq_len=kw["q_seq_len"],
                                  window=kw["window"], logit_softcap=kw["logit_softcap"],
                                  kv_len=kw["kv_len"])
    validate_result(got, np.asarray(want, np.float32), TOL, name="o")


@pytest.mark.parametrize("case", [c for c in CASES if c[9] is None], ids=lambda c: c[0])
def test_tc_backward_matches_jax_bf16(case):
    """attention_vjp's gradients, whose CPU backward is the fused form's
    plain version with the tensor-core rounding, against JAX's in bf16."""
    q, k, v, do = _inputs(case, 2)
    kw = _kw(case)
    del kw["kv_len"]
    if q.shape[2] in tflash.TC_HEAD_DIMS["flash_bwd"]:
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


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tc_rounding_moves_the_forward(case):
    """The mirrored rounding is live: the tc form's plain forward differs
    from the scalar form's, by no more than bf16 rounding, and with q, k, v
    in float32 (the scalar form) the default is the scalar one."""
    q, k, v, _ = _inputs(case, 3)
    kw = _kw(case)
    tc = tflash.flash_attention_plain(q, k, v, form="tc", **kw)
    scalar = tflash.flash_attention_plain(q, k, v, form="scalar", **kw)
    gap = float((tc.float() - scalar.float()).abs().max())
    assert 0.0 < gap < TOL
    assert torch.equal(tflash.flash_attention_plain(q, k, v, **kw), tc)
    f32 = [x.float() for x in (q, k, v)]
    assert torch.equal(tflash.flash_attention_plain(*f32, **kw),
                       tflash.flash_attention_plain(*f32, form="scalar", **kw))


@pytest.mark.parametrize("case", CASES[:3], ids=[c[0] for c in CASES[:3]])
def test_tc_rounding_moves_the_backward(case):
    q, k, v, do = _inputs(case, 4)
    kw = _kw(case)
    o, l, m = tflash.flash_attention_plain(q, k, v, save_residuals=True, **kw)
    lse = m + torch.log(l)
    tc = tbwd.flash_attention_bwd_plain(q, k, v, o, lse, do, form="tc", **kw)
    scalar = tbwd.flash_attention_bwd_plain(q, k, v, o, lse, do, form="scalar", **kw)
    gaps = [float((a.float() - b.float()).abs().max()) for a, b in zip(tc, scalar)]
    assert all(0.0 < x < TOL for x in gaps), gaps


def test_tc_forward_rounds_against_the_running_max():
    """One row over two KV tiles whose second tile holds a larger score:
    p of the first tile is split into its two bf16 terms at its own tile's
    max, then rescaled, exactly as written out here (in float32: the
    residuals' m and l, and o before its bf16 rounding, through a float32
    v)."""
    tile = tflash.TC_KV_TILE[64]
    s_kv = 2 * tile
    rng = np.random.default_rng(5)
    q = torch.zeros(1, 1, 64, dtype=torch.bfloat16)
    q[0, 0, 0] = 1.0
    k = torch.tensor(rng.uniform(-3, 0, (1, s_kv, 64)).astype(np.float32)).to(torch.bfloat16)
    k[0, tile + 3, 0] = 4.0  # the row's max lies in the second tile
    v = torch.tensor(rng.standard_normal((1, s_kv, 64)).astype(np.float32)).to(torch.bfloat16)
    s = (q.float() @ k.float().transpose(1, 2))[0, 0]
    m1, m = s[:tile].max(), s.max()

    def two_terms(x):
        hi = x.bfloat16().float()
        return hi + (x - hi).bfloat16().float()

    p1 = two_terms(torch.exp(s[:tile] - m1)) * torch.exp(m1 - m)
    p2 = two_terms(torch.exp(s[tile:] - m))
    want = (torch.cat([p1, p2]).double() @ v[0].double()) / torch.exp(s - m).double().sum()
    got = tflash.flash_attention_plain(q, k, v, form="tc").float()
    assert float((got[0, 0].double() - want).abs().max()) <= 2**-8 * float(want.abs().max())
    # Rounding p once per tile, or against the final max, would be another
    # function: the split matters only beyond bf16, so compare before it.
    scalar = tflash.flash_attention_plain(q, k, v, form="scalar").float()
    assert float((got - scalar).abs().max()) <= 2**-8 * float(want.abs().max())
