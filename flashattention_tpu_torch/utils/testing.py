"""Test-oracle utilities: comparators, input factories and a numpy bridge.

Counterpart of ``flashattention_tpu/utils/testing.py`` (same tolerances and
comparators), plus :func:`to_torch` / :func:`to_numpy`, the bridge that the
differential tests and :func:`models.transformer.params_from_jax` use to move
arrays between the two frameworks through numpy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "TOL_FP32",
    "TOL_BF16",
    "TOL_PUBLIC",
    "validate_result",
    "max_abs_err",
    "make_random",
    "make_iota",
    "make_ones",
    "to_torch",
    "to_numpy",
]

TOL_FP32 = 1e-4   # kernel-lab gate (fp32, dense config)
TOL_BF16 = 2e-2   # bf16 gate
TOL_PUBLIC = 1e-1  # public-API gate vs eager reference


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return to_numpy(x).astype(np.float32)
    return np.asarray(x, dtype=np.float32)


def max_abs_err(got, want) -> float:
    return float(np.max(np.abs(_as_f32(got) - _as_f32(want))))


def validate_result(got, want, tol: float, *, name: str = "tensor", max_faults: int = 10):
    """Assert elementwise |got - want| <= tol, reporting the first few faults.

    NaNs in ``want`` are ignored (treated as match)."""
    got, want = _as_f32(got), _as_f32(want)
    assert got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}"
    diff = np.abs(got - want)
    diff[np.isnan(want)] = 0.0
    bad = np.argwhere(diff > tol)
    if bad.size:
        lines = [
            f"{name}: {len(bad)} elements exceed tol={tol} "
            f"(max_abs_err={diff.max():.3e})"
        ]
        for idx in bad[:max_faults]:
            t = tuple(int(i) for i in idx)
            lines.append(f"  at {t}: got={got[t]:.6f} want={want[t]:.6f}")
        raise AssertionError("\n".join(lines))


def make_random(generator: torch.Generator, shape, dtype=torch.float32, *, lo=-1.0, hi=1.0):
    """Uniform random tensor in [lo, hi) on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * (hi - lo) + lo).to(dtype)


def make_iota(shape, dtype=torch.float32, *, period: int = 97, device=None):
    """Deterministic bounded iota: values repeat mod ``period`` so exp never
    overflows at long S."""
    n = int(np.prod(shape))
    x = torch.arange(n, dtype=torch.float32, device=device) % period
    return (x.reshape(shape) / period).to(dtype)


def make_ones(shape, dtype=torch.float32, *, device=None):
    return torch.ones(shape, dtype=dtype, device=device)


def to_torch(a, device=None) -> torch.Tensor:
    """numpy array -> tensor, keeping bfloat16 and fp8.

    numpy's bfloat16 and float8_e4m3fn (``ml_dtypes`` types, what JAX arrays
    of those dtypes become) are types ``torch.from_numpy`` refuses, so their
    bits cross as ``uint16`` and ``uint8``."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:  # e.g. a view of a JAX array: torch wants to own it
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    elif a.dtype.name == "float8_e4m3fn":
        t = torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    else:
        t = torch.from_numpy(a)
    return t.to(device) if device is not None else t


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """tensor -> numpy on the host; bfloat16 and fp8 come back as float32
    (exact)."""
    t = t.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float8_e4m3fn):
        t = t.float()
    return t.numpy()
