"""Guards on the port's boundaries.

- ``flashattention_tpu_torch`` imports neither JAX nor the JAX package, when
  imported (checked in a fresh interpreter, the CLIs, ``ops/probes.py`` and
  the self-test among the modules) or anywhere in its sources; nor do
  ``chip_smoke.py`` and the card scripts of ``torch_tools/``;
- its entry points run on the card unless the caller asks for the CPU, and
  raise instead of carrying on where there is no card;
- options of later slices raise ``NotImplementedError``, each naming the
  slice that brings it, and those ported since run (attention dropout and
  block masks with the JAX package's own refusals: a rate outside (0, 1),
  dropout on the ``xla`` oracle, a block mask on the fused backward).
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

from flashattention_tpu_torch.models import train, transformer
from flashattention_tpu_torch.ops import backward, decode
from flashattention_tpu_torch.runtime import engine, kvcache

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "flashattention_tpu_torch")


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith(("jax.", "jaxlib")) or (
        name == "flashattention_tpu" or name.startswith("flashattention_tpu.")
    )


def test_import_loads_no_jax():
    code = (
        "import sys, flashattention_tpu_torch\n"
        "import flashattention_tpu_torch.runtime.engine\n"
        "import flashattention_tpu_torch.utils.benchit\n"
        "import flashattention_tpu_torch.utils.checkpoint\n"
        "import flashattention_tpu_torch.models.train\n"
        "import flashattention_tpu_torch.ops.probes\n"
        "import flashattention_tpu_torch.utils.selftest\n"
        "from flashattention_tpu_torch.cli import (bench, bench_decode, bench_flashattention,\n"
        "    bench_serving, bench_train, lab, smoke)\n"
        "print('\\n'.join(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        check=True, timeout=120, env={**os.environ, "PYTHONPATH": ROOT},
    ).stdout.split()
    assert "flashattention_tpu_torch.runtime.engine" in out
    assert "flashattention_tpu_torch.utils.checkpoint" in out
    assert "flashattention_tpu_torch.cli.bench_serving" in out
    assert "flashattention_tpu_torch.ops.probes" in out
    assert [m for m in out if _forbidden(m)] == []


def test_sources_import_no_jax():
    bad = []
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                bad += [(path, n) for n in names if _forbidden(n)]
    assert bad == []


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if _forbidden(n)]


@pytest.mark.parametrize(
    "script",
    ["decode_ab.py", "window_mutants.py", "quant_mutants.py", "bwd_mutants.py", "draft_mutants.py",
     "spec_drift.py", "fwd_bwd_ab.py", "dropout_mutants.py", "probe_d128.py", "probe_fp32.py",
     "f32_mutants.py", "tc_mutants.py", "probe_stream.py", "pair_f32_gemma.py",
     "fused_f32_gemma.py"],
)
def test_tools_import_no_jax(script):
    """The card scripts in ``torch_tools/`` drive the port alone (all but
    spec_drift.py through chip_smoke's checks; probe_d128.py and
    probe_fp32.py through its probe checks and timings, over
    ``ops/probes.py``)."""
    with open(os.path.join(ROOT, "torch_tools", script)) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert "chip_smoke" in names or script == "spec_drift.py"
    assert not [n for n in names if _forbidden(n)]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA card exists")


def test_entry_points_default_to_the_card(no_card):
    cfg = transformer.ModelConfig.tiny()
    ccfg = kvcache.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, num_pages=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kvcache.PagedKVCache(ccfg)
    params = transformer.init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.Engine(params, cfg, ccfg, engine.EngineConfig(prefill_chunk=0))
    for make in (train.make_train_step, train.make_train_step_packed):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):  # dropout, too
            make(cfg, attn_dropout=0.1)
    for dt in ("int8", "fp8"):  # an 8-bit cache, too, runs on the card unless asked
        qcfg = kvcache.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, num_pages=4, dtype=dt)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            kvcache.PagedKVCache(qcfg)
        assert kvcache.PagedKVCache(qcfg, device="cpu").k_scales.shape == (2, 4, 2, 256)
    step = train.make_train_step(cfg, device="cpu")
    with pytest.raises(ValueError, match="runs on cpu"):
        step(params, torch.zeros(1, 8, dtype=torch.int32, device="meta"))


def test_moe_and_checkpoint_default_to_the_card(no_card, tmp_path):
    """The MoE model, the optimizer step and ``load_checkpoint`` run on the
    card unless the caller asks for the CPU."""
    from flashattention_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg = transformer.ModelConfig(vocab_size=32, num_layers=1, d_model=32, num_q_heads=2,
                                  num_kv_heads=1, head_dim=16, intermediate=32,
                                  num_experts=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(0, cfg)
    params = transformer.init_params(0, cfg, device="cpu")
    assert params["layers"][0]["router"].device.type == "cpu"
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_checkpoint(path)
    assert load_checkpoint(path, device="cpu")[0]["embed"].device.type == "cpu"
    opt = train.adamw(1e-3)
    for make in (lambda **kw: train.make_train_step_optax(cfg, opt, **kw),
                 lambda **kw: train.make_train_step_packed(cfg, optimizer=opt, **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert callable(make(device="cpu"))


def test_later_slices_raise():
    q = torch.zeros(1, 2, 2, 32)
    pages = torch.zeros(3, 2, 8, 32)
    lens, table = torch.ones(1, dtype=torch.int32), torch.zeros(1, 2, dtype=torch.int32)
    # Speculative verification's draft form: ported; q's rows must hold k per head.
    assert decode.paged_attention(q, pages, pages, lens + 1, table, draft_k=2).shape == q.shape
    with pytest.raises(ValueError, match="multiple of draft_k"):
        decode.paged_attention(torch.zeros(1, 2, 3, 32), pages, pages, lens + 1, table, draft_k=2)
    decode.paged_attention(q, pages, pages, lens, table, window=4, logit_softcap=30.0)  # ported
    qp = torch.zeros(1, 2, 8, 32)
    scales = torch.ones(3, 2, 8)
    pages8 = pages.to(torch.int8)
    # 8-bit pages with their scales: ported (the quantized-serving slice).
    decode.paged_attention(q, pages8, pages8, lens, table, k_scales_pages=scales,
                           v_scales_pages=scales)
    for kw in (dict(k_scales_pages=scales, v_scales_pages=scales),):
        decode.paged_prefill_attention_batched(qp, pages8, pages8, table, lens, chunk=8, **kw)
        decode.paged_prefill_attention(qp[0], pages8, pages8, table[0], 8, chunk=8, **kw)
    for dt in ("int8", "fp8"):
        assert kvcache.CacheConfig(num_layers=1, num_kv_heads=2, head_dim=32, dtype=dt).quantized
    import flashattention_tpu_torch as ft

    x = torch.zeros(1, 2, 8, 32)
    x3 = x.reshape(2, 8, 32)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    ft.attention(x, x, x, causal=True, q_segment_ids=seg, kv_segment_ids=seg)  # ported
    ft.attention(x, x, x, causal=True, window=4, logit_softcap=30.0)  # ported, forward
    x8, sc = x.to(torch.int8), torch.ones(1, 2, 8)
    ft.attention(x, x8, x8, causal=True, k_scales=sc, v_scales=sc)  # ported, forward
    with pytest.raises(NotImplementedError, match="backward"):  # no backward kernel
        ft.attention(x.requires_grad_(), x8, x8, causal=True, k_scales=sc, v_scales=sc)
    x = x.detach()
    for kw in (dict(window=4), dict(logit_softcap=30.0)):  # ported (Gemma-2/Mistral training)
        assert backward.attention_vjp(x3, x3, x3, True, **kw).shape == x3.shape
        grads = backward.flash_attention_bwd(x3, x3, x3, x3, x3[..., 0], x3, causal=True, **kw)
        assert [g.shape for g in grads] == [x3.shape] * 3
    # Attention dropout: ported, with the JAX package's refusals.
    assert ft.attention(x, x, x, causal=True, dropout_rate=0.1).shape == x.shape
    assert backward.attention_vjp(x3, x3, x3, True, dropout_rate=0.1).shape == x3.shape
    grads = backward.flash_attention_bwd(x3, x3, x3, x3, x3[..., 0], x3, dropout_rate=0.1)
    assert [g.shape for g in grads] == [x3.shape] * 3
    with pytest.raises(NotImplementedError, match="kernel-PRNG-defined"):
        ft.attention(x, x, x, causal=True, implementation="xla", dropout_rate=0.1)
    for rate in (1.0, -0.1, 1.5):
        with pytest.raises(ValueError, match=r"dropout_rate must be in \(0, 1\)"):
            ft.attention(x, x, x, causal=True, dropout_rate=rate)
        with pytest.raises(ValueError, match=r"dropout_rate must be in \(0, 1\)"):
            backward.attention_vjp(x3, x3, x3, True, dropout_rate=rate)
        with pytest.raises(ValueError, match=r"dropout_rate must be in \(0, 1\)"):
            backward.flash_attention_bwd(x3, x3, x3, x3, x3[..., 0], x3, dropout_rate=rate)
    # Block masks: ported; the fused backward refuses them, as in JAX.
    bm = ft.BlockMask.from_mask_fn(lambda r, c: c <= r, 8, 8, block_q=8, block_kv=8)
    assert ft.attention(x, x, x, block_mask=bm).shape == x.shape
    assert backward.attention_vjp(x3, x3, x3, False, block_mask=bm).shape == x3.shape
    with pytest.raises(ValueError, match="fused backward does not support block_mask"):
        backward.flash_attention_bwd(x3, x3, x3, x3, x3[..., 0], x3, block_mask=bm, fused=True)
    with pytest.raises(NotImplementedError, match="block_mask"):
        ft.attention(x, x, x, implementation="xla", block_mask=bm)
    cfg = transformer.ModelConfig.tiny()
    for make in (train.make_train_step, train.make_train_step_packed):
        assert callable(make(cfg, attn_dropout=0.1, device="cpu"))  # ported
        with pytest.raises(ValueError, match="dropout_rate"):
            make(cfg, attn_dropout=1.5, device="cpu")
    for cfg in (transformer.ModelConfig.mistral7b(), transformer.ModelConfig.gemma2_9b()):
        for make in (train.make_train_step, train.make_train_step_packed):  # ported
            assert callable(make(cfg, device="cpu"))
