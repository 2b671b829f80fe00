"""``utils/benchit.py``'s accounting against the JAX package's.

``attention_flops`` and :class:`BenchResult`'s rate are the JAX functions'
own arithmetic.  The two attention ceilings equal the JAX ones at d = 128
and 256, in bf16 and float32, for every causal / two-pass / s / block case,
with the JAX ``chip_peak`` patched to the H100's figures (989 TFLOP/s bf16,
67 float32, 3.35 TB/s).  Where the card differs by design it is asserted by
name: no TPU lane waste below d = 128, and the float32 peak for the modes the
port runs as exact float32.  Off the card the peaks are None, as the JAX
ones are off a TPU.
"""

import itertools

import pytest
import torch

from flashattention_tpu.utils import benchit as jb
from flashattention_tpu_torch.utils import benchit as tb

torch.set_num_threads(2)

H100 = "H100 80GB HBM3"


@pytest.fixture
def jax_on_h100(monkeypatch):
    """The JAX accounting with the H100's peaks in place of a TPU's."""
    monkeypatch.setattr(jb, "chip_peak", lambda dtype_bits=16: (
        989.0 if dtype_bits <= 16 else 67.0, 3350.0))
    monkeypatch.setattr(jb, "_is_v5e", lambda: False)


@pytest.mark.parametrize("bh,s_q,s_kv,d,causal", [
    (1, 128, 128, 64, False), (16, 8192, 8192, 64, True), (128, 2048, 2048, 128, False),
    (4, 512, 700, 256, True), (3, 1, 4096, 128, False)])
def test_attention_flops_equal_jax(bh, s_q, s_kv, d, causal):
    assert tb.attention_flops(bh, s_q, s_kv, d, causal=causal) == jb.attention_flops(
        bh, s_q, s_kv, d, causal=causal)


@pytest.mark.parametrize("d,precision", itertools.product((128, 256), ("bf16", "float32")))
def test_forward_ceiling_equals_jax_at_d128_and_up(jax_on_h100, d, precision):
    assert tb.attention_ceiling_tflops(d, precision, card=H100) == pytest.approx(
        jb.attention_ceiling_tflops(d, precision), rel=1e-12)


@pytest.mark.parametrize("d,precision,causal,two_pass,s,block", [
    (d, p, c, t, s, b) for d in (128, 256) for p in ("bf16", "float32")
    for c in (False, True) for t in (False, True) for s, b in ((4096, 1024), (8192, 512),
                                                                (2048, 2048), (512, 1024))])
def test_backward_ceiling_equals_jax_at_d128_and_up(jax_on_h100, d, precision, causal, two_pass,
                                                     s, block):
    got = tb.attention_bwd_ceiling_tflops(d, precision, s=s, block=block, causal=causal,
                                          two_pass=two_pass, card=H100)
    want = jb.attention_bwd_ceiling_tflops(d, precision, s=s, block=block, causal=causal,
                                           two_pass=two_pass)
    assert got == pytest.approx(want, rel=1e-12)


def test_no_lane_waste_below_d128(jax_on_h100):
    """wgmma has no 128-lane pass: below d = 128 the card's ceiling stays its
    peak, where the TPU's falls with d / 128."""
    for d in (16, 32, 64, 80, 96):
        assert tb.attention_ceiling_tflops(d, "bf16", card=H100) == 989.0
        assert jb.attention_ceiling_tflops(d, "bf16") == pytest.approx(989.0 * d / 128)
        assert tb.attention_bwd_ceiling_tflops(d, "bf16", causal=False, two_pass=False,
                                               card=H100) == 989.0


def test_float32_modes_take_the_float32_peak(jax_on_h100):
    """``float32`` keeps the JAX accounting, the float32 peak, as do
    ``bf16_3x`` and ``packed`` where the float32 tensor-core form is not
    built (d = 32); at d = 64, 128 and 256 those two run on the bf16 peak
    over four, three and three products a useful one."""
    for d in (32, 64, 128, 256):
        assert tb.attention_ceiling_tflops(d, "float32", card=H100) == 67.0
        for mode in ("bf16_3x", "packed"):
            want = {64: 989.0 / 4, 128: 989.0 / 3, 256: 989.0 / 3}.get(d, 67.0)
            assert tb.attention_ceiling_tflops(d, mode, card=H100) == want
            assert tb.attention_bwd_ceiling_tflops(d, mode, causal=False, two_pass=False,
                                                   card=H100) == 67.0
    assert tb.attention_ceiling_tflops(128, "int8", card=H100) is None


def test_bench_result_rate_equals_jax():
    for ms, flops in ((1.0, 0.0), (0.25, 3.4e10), (12.5, 2.75e11)):
        assert tb.BenchResult(ms, ms, 3, flops).tflops_per_s == pytest.approx(
            jb.BenchResult(ms, ms, 3, flops).tflops_per_s, rel=1e-15)


def test_benchmark_and_devtime_on_the_cpu():
    x = torch.ones(64)
    r = tb.benchmark(lambda x: x + 1, x, repeats=4, warmup=1, flops=1e6)
    assert r.repeats == 4 and 0 < r.ms_min <= r.ms
    assert r.tflops_per_s == pytest.approx(1e6 / (r.ms * 1e-3) / 1e12)
    assert tb.devtime_ms(lambda x: x * 2, (x,), n_hi=9, trials=2) > 0


def test_peaks_off_the_card():
    assert tb.chip_peak(16, device="cpu") is None
    assert tb.roofline(tb.BenchResult(1.0, 1.0, 1, 1e9), device="cpu") is None
    assert tb.attention_ceiling_tflops(128, device="cpu") is None
    assert tb.attention_bwd_ceiling_tflops(128, device="cpu") is None
    assert tb.measured_hbm_gbps(device="cpu") is None
    assert tb.chip_peak(32, card=H100) == (67.0, 3350.0)
    assert tb.roofline(tb.BenchResult(1.0, 1.0, 1, 989e9), card=H100) == pytest.approx(1.0)
    with pytest.raises(KeyError, match="no peak rates"):
        tb.chip_peak(16, card="Tesla K80")
