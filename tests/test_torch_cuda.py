"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips where no card exists.  This file
imports neither JAX nor the JAX package, so it runs on a GPU host that has
only PyTorch::

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest sets up JAX's CPU devices).  Each
kernel is held, for every head_dim and group size it is instantiated for, to
its plain version run on the CPU: 1e-4 in float32, 2e-2 in bfloat16 (one
bf16 rounding of outputs of magnitude ~1).
"""

import dataclasses

import numpy as np
import pytest
import torch

from flashattention_tpu_torch.models import transformer
from flashattention_tpu_torch.ops import decode, flash
from flashattention_tpu_torch.runtime import engine, kvcache
from flashattention_tpu_torch.utils.testing import validate_result

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(autouse=True)
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _randn(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize(
    "kw",
    [
        dict(s_kv=250, causal=False),
        dict(s_kv=250, causal=True),
        dict(s_kv=100, causal=True, q_seq_len=70, q_offset=30),  # GQA fold, 3 groups
        dict(s_kv=100, causal=True, kv_len=77, q_offset=60, save_residuals=True),
    ],
    ids=["full", "causal", "gqa_fold", "kv_len_residuals"],
)
def test_flash_kernel_matches_plain(dtype, d, kw):
    kw = dict(kw)
    s_kv = kw.pop("s_kv")
    q = _randn((3, 210, d), dtype, 0)
    k, v = _randn((3, s_kv, d), dtype, 1), _randn((3, s_kv, d), dtype, 2)
    got = flash.flash_attention(q.cuda(), k.cuda(), v.cuda(), scale=d**-0.5, **kw)
    want = flash.flash_attention(q, k, v, scale=d**-0.5, **kw)
    torch.cuda.synchronize()
    if kw.get("save_residuals"):
        for g, w in zip(got[1:], want[1:]):
            validate_result(g, w, 1e-5 * float(w.abs().max()))
        got, want = got[0], want[0]
    validate_result(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_paged_kernel_matches_plain(dtype, d, g):
    kvh, ps, pages, pps = 2, 16, 30, 5
    lengths = torch.tensor([0, 1, 16, 17, 80], dtype=torch.int32)
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(3))[: 5 * pps]
    table = table.reshape(5, pps).to(torch.int32).contiguous()
    q = _randn((5, kvh, g, d), dtype, 4)
    kp, vp = _randn((pages, kvh, ps, d), dtype, 5), _randn((pages, kvh, ps, d), dtype, 6)
    args = (q, kp, vp, lengths, table)
    got = decode.paged_attention(*(a.cuda() for a in args), scale=d**-0.5)
    want = decode.paged_attention(*args, scale=d**-0.5)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[0]) == 0  # length 0: zeros
    validate_result(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_paged_prefill_kernel_matches_plain(dtype, d, g):
    """A dummy ctx = 0 row, a chunk-only row, a ragged context and a full
    table; seg = 24 > chunk = 20, so 32-row tiles cross segments."""
    kvh, ps, pages, pps, chunk, seg = 2, 16, 40, 6, 20, 24
    ctx = torch.tensor([0, 20, 37, 96], dtype=torch.int32)
    table = torch.randperm(pages, generator=torch.Generator().manual_seed(7))[: 4 * pps]
    table = table.reshape(4, pps).to(torch.int32).contiguous()
    q = _randn((4, kvh, g * seg, d), dtype, 8)
    kp, vp = _randn((pages, kvh, ps, d), dtype, 9), _randn((pages, kvh, ps, d), dtype, 10)
    args = (q, kp, vp, table, ctx)
    kw = dict(chunk=chunk, seg=seg, scale=d**-0.5)
    got = decode.paged_prefill_attention_batched(*(a.cuda() for a in args), **kw)
    want = decode.paged_prefill_attention_batched(*args, **kw)
    one = decode.paged_prefill_attention(q[2].cuda(), kp.cuda(), vp.cuda(), table[2].cuda(), 37, **kw)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got[0]) == 0  # ctx = 0: zeros
    validate_result(got, want, TOL[dtype])
    validate_result(one, want[2], TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize(
    "kw",
    [dict(causal=False), dict(causal=True, q_offset=54), dict(causal=True, kv_len=77, q_offset=30)],
    ids=["full", "causal", "kv_len_q_offset"],
)
def test_naive_kernel_matches_plain_and_flash(dtype, d, kw):
    q = _randn((3, 96, d), dtype, 11)
    k, v = _randn((3, 150, d), dtype, 12), _randn((3, 150, d), dtype, 13)
    got = flash.flash_attention_naive(q.cuda(), k.cuda(), v.cuda(), scale=d**-0.5, block_q=32, **kw)
    want = flash.flash_attention_naive(q, k, v, scale=d**-0.5, block_q=32, **kw)
    fwd = flash.flash_attention(q.cuda(), k.cuda(), v.cuda(), scale=d**-0.5, **kw)
    torch.cuda.synchronize()
    validate_result(got, want, TOL[dtype])
    validate_result(got, fwd, TOL[dtype])  # two kernels, two softmax routes


def test_engine_on_card_matches_cpu():
    """Greedy tokens of the tiny float32 model, served on the card with the
    kernels, equal the CPU engine's (plain versions)."""
    cfg = dataclasses.replace(transformer.ModelConfig.tiny(), dtype="float32")
    params = transformer.init_params(0, cfg, device="cpu")
    outs = []
    for dev in ("cpu", "cuda"):
        p = {k: (v.to(dev) if torch.is_tensor(v) else [{n: w.to(dev) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        cc = kvcache.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8,
                                 num_pages=6, dtype="float32")
        eng = engine.Engine(p, cfg, cc, engine.EngineConfig(max_batch=3, pages_per_seq=3,
                                                            prefill_chunk=0), device=dev)
        rng = np.random.default_rng(0)
        for n in (3, 9, 17, 5):
            eng.add_request(rng.integers(0, 256, n).tolist(), 6)
        outs.append(eng.run())
        assert eng.cache.num_free_pages() == 6
    assert outs[0] == outs[1]


def test_chunked_engine_on_card_matches_cpu():
    """The same with chunked prefill and a prefix hit: one donor prompt,
    then two prompts sharing its first two pages."""
    cfg = dataclasses.replace(transformer.ModelConfig.tiny(), dtype="float32")
    params = transformer.init_params(0, cfg, device="cpu")
    base = np.random.default_rng(1).integers(0, 256, 16).tolist()
    outs = []
    for dev in ("cpu", "cuda"):
        p = {k: (v.to(dev) if torch.is_tensor(v) else [{n: w.to(dev) for n, w in lay.items()} for lay in v])
             for k, v in params.items()}
        cc = kvcache.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8,
                                 num_pages=16, dtype="float32")
        eng = engine.Engine(p, cfg, cc, engine.EngineConfig(max_batch=4, pages_per_seq=5,
                                                            prefill_chunk=8), device=dev)
        eng.add_request(base + [3, 4, 5], 6)
        eng.step()
        for tail in ([9], [1, 2, 3, 4, 5, 6, 7, 8, 9, 10]):
            eng.add_request(base + tail, 6)
        outs.append((eng.run(), eng.stats()["prefill_tokens"]))
        assert eng.cache.num_free_pages() == 16
    assert outs[0] == outs[1]
