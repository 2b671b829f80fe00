"""``utils/selftest.py``: the JAX battery's 21 checks, on the CPU through the
plain versions.

Every check passes here; the names are the JAX ``CHECKS``' in order; a plain
version patched to return a wrong result makes its check fail, and ``run``
reports it by name; on the card a check whose kernel did not launch fails
(the launch assertion is exercised here with a device that says ``cuda``).
"""

import pytest
import torch

from flashattention_tpu.utils import selftest as jselftest
from flashattention_tpu_torch.ops import decode, flash
from flashattention_tpu_torch.utils import selftest

torch.set_num_threads(2)


@pytest.mark.parametrize("check", selftest.CHECKS, ids=lambda f: f.__name__)
def test_check_passes_on_the_cpu(check):
    check("cpu")


def test_names_are_the_jax_checks():
    assert [f.__name__ for f in selftest.CHECKS] == [f.__name__ for f in jselftest.CHECKS]
    assert len(selftest.CHECKS) == 21


def _wrong(fn):
    """``fn`` whose output (first output) is off by 0.1 more at each call,
    so it fails against an oracle and against its own other launches."""
    calls = []

    def wrong(*args, **kw):
        calls.append(1)
        out = fn(*args, **kw)
        if isinstance(out, tuple):
            return (out[0] + 0.1 * len(calls), *out[1:])
        return out + 0.1 * len(calls)
    return wrong


@pytest.mark.parametrize("target,attr,check", [
    (flash, "flash_attention_plain", "check_fwd_fp32_default"),
    (flash, "flash_attention_plain", "check_fwd_large_head_dim"),
    (decode, "paged_attention_plain", "check_decode_bf16"),
    (decode, "paged_prefill_attention_plain", "check_paged_prefill_batched"),
])
def test_a_wrong_plain_version_fails_its_check(monkeypatch, target, attr, check):
    monkeypatch.setattr(target, attr, _wrong(getattr(target, attr)))
    passed, failed, failures = selftest.run(verbose=False, device="cpu")
    assert check in [name for name, _ in failures]
    assert failed == len(failures) and passed + failed == 21


def test_a_kernel_that_did_not_launch_fails():
    with pytest.raises(AssertionError, match="not launched"):
        with selftest._launches(torch.device("cuda"), "flash_fwd"):
            pass
    with selftest._launches(torch.device("cpu"), "flash_fwd"):  # the CPU runs no kernel
        pass


def test_run_reports_each_check_and_its_launches():
    recs = []
    assert selftest.run(verbose=False, device="cpu", records=recs) == (21, 0, [])
    assert [r["check"] for r in recs] == [f.__name__ for f in selftest.CHECKS]
    assert all(r["ok"] and r["error"] is None and r["launches"] == {} for r in recs)
