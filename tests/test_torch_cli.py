"""The port's CLIs (``flashattention_tpu_torch/cli/``) on the CPU.

Each runs in process with ``--device cpu`` at tiny shapes and prints the
rows of the root JAX CLI of its name under the same keys (read off the JAX
source's dict literals; where a JAX key names a TPU, the port names the
card instead), each row with ``card`` (None on the CPU).  ``matmul_params``
equals the root ``bench_train.matmul_params`` for the repo's presets; the
lab's seven rungs pass their gates; ``bench`` reports its self-test and
exits non-zero when a check fails; with no card and no ``--device cpu`` a
CLI raises.
"""

import ast
import importlib.util
import json
import os

import pytest
import torch

from flashattention_tpu.models import transformer as jtransformer
from flashattention_tpu_torch.cli import (bench, bench_decode, bench_flashattention,
                                          bench_serving, bench_train, lab, smoke)
from flashattention_tpu_torch.models import transformer as ttransformer
from flashattention_tpu_torch.utils import selftest

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# JAX keys that name a TPU, and the port's for the card.
RENAMED = {"mfu_vs_v5e_bf16_peak": "mfu_vs_card_bf16_peak"}
# JAX keys of rows only a TPU prints (roofline over a known chip; the error rows).
OPTIONAL = {"roofline_frac", "hbm_frac", "profile_dir", "error", "detail"}


def _jax_keys(script: str) -> set:
    """The keys of the rows a root JAX CLI prints: its dict literals passed
    to ``json.dumps`` or ``rows.append`` or assigned to ``row``."""
    with open(os.path.join(ROOT, script)) as fh:
        tree = ast.parse(fh.read())
    dicts = [n.args[0] for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Attribute) and n.func.attr in ("dumps", "append")
             and n.args and isinstance(n.args[0], ast.Dict)]
    dicts += [n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
              and isinstance(n.value, ast.Dict) and [getattr(t, "id", None) for t in n.targets]
              == ["row"]]
    keys = {k.value for d in dicts for k in d.keys if isinstance(k, ast.Constant)}
    keys |= {n.slice.value for n in ast.walk(tree) if isinstance(n, ast.Subscript)
             and isinstance(n.value, ast.Name) and n.value.id == "row"
             and isinstance(n.slice, ast.Constant)}
    return keys


def _rows(capsys):
    lines = capsys.readouterr().out.splitlines()
    return [json.loads(ln) for ln in lines if ln.startswith("{")], lines


def _assert_keys(script, rows, *, card_rows):
    want = {RENAMED.get(k, k) for k in _jax_keys(script)} - OPTIONAL
    got = set().union(*(r.keys() for r in rows))
    assert want <= got, sorted(want - got)
    carded = [r["card"] for r in rows if "card" in r]
    assert carded == [None] * card_rows


@pytest.fixture
def tiny_bench(monkeypatch):
    """``bench``'s shapes cut for the CPU: S 256, the Llama shape to BH 2 at
    S 256, decode contexts of 1024."""
    monkeypatch.setattr(bench, "S", 256)
    monkeypatch.setattr(bench, "LLAMA", (2, 256))
    monkeypatch.setattr(bench, "DECODE_S", 1024)


def test_bench(tiny_bench, capsys):
    bench.main(["--device", "cpu"])
    rows, _ = _rows(capsys)
    _assert_keys("bench.py", rows, card_rows=1)
    assert rows[0]["compiled_selftest"] == "21/21 pass"
    assert rows[0]["metric"] == "fwd_attention_latency_B2_H8_d64_S256_fp32"


def test_bench_fails_on_a_failed_selftest(tiny_bench, monkeypatch, capsys):
    def broken(device=None):
        raise AssertionError("wrong")

    broken.__name__ = "check_fwd_fp32_default"
    monkeypatch.setattr(selftest, "CHECKS", [broken, *selftest.CHECKS[1:]])
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu"])
    assert e.value.code == 1
    rows, lines = _rows(capsys)
    assert "selftest FAIL check_fwd_fp32_default: AssertionError: wrong" in lines
    assert rows[0]["compiled_selftest"] == "20/21 pass"


def test_bench_flashattention(capsys, tmp_path):
    bench_flashattention.main(["--device", "cpu", "--batch_size", "2", "--seq_len", "128",
                               "--masking", "--profile", str(tmp_path)])
    rows, lines = _rows(capsys)
    _assert_keys("bench_flashattention.py", rows, card_rows=2)
    assert rows[-1]["allclose_atol_1e-1"] and lines[-1] == "attention output correct"
    assert os.path.exists(tmp_path / "trace.json")


def test_bench_decode(capsys):
    bench_decode.main(["--device", "cpu", "--batch", "2", "--kv_heads", "2", "--seq_len", "512",
                       "--page_size", "64", "--kv_dtypes", "bfloat16,float32,int8,fp8"])
    rows, _ = _rows(capsys)
    _assert_keys("bench_decode.py", rows, card_rows=4)
    assert [r["kv_dtype"] for r in rows] == ["bfloat16", "float32", "int8", "fp8"]
    assert all(r["valid"] for r in rows)


def test_clis_pass_float32_q_over_bf16_pages(monkeypatch, capsys):
    """As the JAX benches do, ``bench_decode``'s bf16 row and ``bench``'s
    decode rate call ``paged_attention`` with float32 q over bf16 pages (the
    entry point takes it in bf16, as the Pallas kernel does, and returns
    float32); over 8-bit pages they take q in bf16 themselves, float32 q
    there running the scalar 8-bit form."""
    from flashattention_tpu_torch.ops import decode

    seen, real = [], decode.paged_attention

    def spy(q, k_pages, *args, **kw):
        o = real(q, k_pages, *args, **kw)
        seen.append((q.dtype, k_pages.dtype, o.dtype))
        return o

    monkeypatch.setattr(decode, "paged_attention", spy)
    bench_decode.main(["--device", "cpu", "--batch", "2", "--kv_heads", "2", "--seq_len", "256",
                       "--page_size", "64", "--kv_dtypes", "bfloat16,int8"])
    rows, _ = _rows(capsys)
    assert all(r["valid"] for r in rows)
    assert set(seen) == {(torch.float32, torch.bfloat16, torch.float32),
                         (torch.bfloat16, torch.int8, torch.bfloat16)}
    seen.clear()
    for kv in ("bf16", "int8"):
        bench._decode_tokens_per_s(torch.device("cpu"), b=2, kvh=2, g=2, d=64, s=1024, ps=256,
                                   kv=kv)
    assert set(seen) == {(torch.float32, torch.bfloat16, torch.float32),
                         (torch.bfloat16, torch.int8, torch.bfloat16)}


def test_bench_serving(monkeypatch, capsys):
    monkeypatch.setattr(bench_serving, "WIDTHS", dict(
        vocab_size=128, d_model=64, num_q_heads=4, num_kv_heads=2, head_dim=32, intermediate=64))
    bench_serving.main(["--device", "cpu", "--layers", "2", "--seq_len", "128",
                        "--page_size", "64", "--steps", "2", "--batch", "2"])
    rows, _ = _rows(capsys)
    _assert_keys("bench_serving.py", rows, card_rows=4)
    assert [(r["kv_dtype"], r["weight_dtype"]) for r in rows] == [
        ("bfloat16", "bfloat16"), ("bfloat16", "int8"), ("int8", "bfloat16"), ("int8", "int8")]


def test_bench_train(capsys):
    bench_train.main(["--device", "cpu", "--smoke"])
    rows, _ = _rows(capsys)
    _assert_keys("bench_train.py", rows, card_rows=2)
    assert rows[0]["metric"] == "train_step_mistral7b_slice_L2_B2_S128_bf16"
    assert rows[1]["metric"] == "train_step_remat_mistral7b_slice_L2_B2_S128_bf16"
    assert all(r["mfu_vs_card_bf16_peak"] is None for r in rows)


def _root_bench_train():
    spec = importlib.util.spec_from_file_location("root_bench_train",
                                                  os.path.join(ROOT, "bench_train.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("preset", ["tiny", "llama7b_attention", "mistral7b", "gemma2_9b",
                                    "mixtral8x7b"])
def test_matmul_params_equal_the_jax_bench(preset):
    jcfg, tcfg = getattr(jtransformer.ModelConfig, preset)(), getattr(
        ttransformer.ModelConfig, preset)()
    assert bench_train.matmul_params(tcfg) == _root_bench_train().matmul_params(jcfg)


@pytest.mark.parametrize("dtype,masking", [("float32", False), ("bfloat16", True)])
def test_lab_rungs_pass_their_gate(capsys, dtype, masking):
    lab.main(["--device", "cpu", "--all", "--batch", "1", "--n_head", "2", "--seq_len", "128",
              "--dtype", dtype, *(["--masking"] if masking else [])])
    rows, _ = _rows(capsys)
    assert [r["kernel"] for r in rows] == list(range(1, 8))
    assert all(r["valid"] == "OK" and r["max_abs_err"] <= r["tol"] for r in rows)
    _assert_keys("lab.py", rows, card_rows=7)
    # d = 64: the bf16 tensor-core form, or float32's in its default "bf16_3x"
    tile = "tensor cores: 128 query rows x 128 KV rows" if dtype == "bfloat16" else (
        "tensor cores, float32 as bf16_3x: 128 query rows x 128 KV rows")
    assert rows[3]["blocks"] == tile


def test_smoke(capsys):
    smoke.main(["--device", "cpu", "--batch", "2", "--seq_len", "256"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "card: None" and lines[-1] == "PASS"


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA card exists")


@pytest.mark.parametrize("cli", [bench, bench_flashattention, bench_decode, bench_serving,
                                 bench_train, lab, smoke])
def test_cli_runs_on_the_card_unless_asked(no_card, cli):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([])
