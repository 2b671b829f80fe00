"""The plain versions of the last three probes against the JAX scripts.

``scripts/probe_d128d.py`` (the transposed schedule), ``probe_d128e.py``
(the thin shapes) and ``probe_small_fp32b.py`` (float32 as two bf16 terms)
build their Pallas kernels at a module-level shape; here each runs on the
CPU in interpret mode at a small one (the modules' ``BH`` and ``S``, and
``NQ``, monkeypatched; ``pl.pallas_call`` given ``interpret=True``, or the
fp32 script's own ``FA_PROBE_INTERPRET`` switch), on inputs made with numpy,
uniform in [-1, 1) as ``utils/testing.make_random`` draws them, and each
variant's output is held against the plain version of its port
(``ops/probes.py``'s ``probe_d128de_plain`` and ``probe_fp32_plain``, what
a CPU tensor runs).  Tolerances, of the output's largest magnitude: 2e-2
for the bf16 modes (the bf16 tolerance of the port's other differential
tests: the port feeds P to PV as two bf16 terms against a running max,
the TPU script takes each product whole); 1e-4 for the packed float32
modes, where both sides do the same two-term arithmetic.
"""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashattention_tpu_torch.ops import probes

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL, FP32_TOL = 2e-2, 1e-4


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _uniform(rng, *shape):
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    got = got.double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def d128_scripts():
    """probe_d128d and probe_d128e at BH = 2, S = 1024, interpreted."""
    mods = {n: _script(n) for n in ("probe_d128d", "probe_d128e")}
    mp = pytest.MonkeyPatch()
    for mod in mods.values():
        mp.setattr(mod, "BH", 2)
        mp.setattr(mod, "S", 1024)
        mp.setattr(mod.pl, "pallas_call", functools.partial(mod.pl.pallas_call, interpret=True))
    yield mods
    mp.undo()


def _d128_inputs(seed):
    rng = np.random.default_rng(seed)
    q, k, v = (jnp.asarray(_uniform(rng, 2, 1024, 128), jnp.bfloat16) for _ in range(3))
    vt = jnp.swapaxes(v, 1, 2)
    as_torch = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    return (q, k, v, vt), tuple(as_torch(x) for x in (q, k, v, vt))


@pytest.mark.parametrize("name", list(probes.D128DE_MODES))
def test_d128de_plain_matches_the_jax_script(name, d128_scripts):
    """Each mode of scripts/probe_d128d.py and probe_d128e.py, unscaled:
    the normal and transposed orientations, V stored either way, O stored
    either way, the full softmax, the two one-heavy-product forms and the
    bf16-rounded PV output."""
    cfg = probes.D128DE_MODES[name]
    variant = cfg.item.split()[1]
    mod = d128_scripts[cfg.item.split(".")[0]]
    (jq, jk, jv, jvt), (tq, tk, tv, tvt) = _d128_inputs(list(probes.D128DE_MODES).index(name))
    want = np.asarray(mod.build(variant)(jq, jk, jvt if cfg.vt else jv))
    got = probes.probe_d128de(name, tq, tk, tvt if cfg.vt else tv)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert _rel(got, want) <= BF16_TOL


@pytest.fixture(scope="module")
def fp32_script():
    """probe_small_fp32b at BH = 8, S = 512 (one grid step), interpreted."""
    mod = _script("probe_small_fp32b")
    mp = pytest.MonkeyPatch()
    mp.setenv("FA_PROBE_INTERPRET", "1")
    mp.setattr(mod, "BH", 8)
    mp.setattr(mod, "S", 512)
    mp.setattr(mod, "NQ", 1)
    yield mod
    mp.undo()


@pytest.mark.parametrize("mode", list(probes.FP32_MODES))
def test_fp32_plain_matches_the_jax_script(mode, fp32_script):
    """Each variant of scripts/probe_small_fp32b.py on the script's own
    packed operands (``pack2``, the ones column), against the plain version
    on the operands ``probes.fp32_inputs`` packs from the same float32
    values: the TPU probe's ``[acc | acc]`` holds acc twice."""
    rng = np.random.default_rng(list(probes.FP32_MODES).index(mode))
    qf, kf, vf = (_uniform(rng, 8, 512, 64) for _ in range(3))
    mod = fp32_script
    if mode == "bf16_skel":
        jargs = (jnp.asarray(qf, jnp.bfloat16), jnp.asarray(kf, jnp.bfloat16),
                 jnp.concatenate([jnp.asarray(vf, jnp.bfloat16),
                                  jnp.ones((8, 512, 1), jnp.bfloat16)], axis=-1))
    else:
        jargs = (mod.pack2(jnp.asarray(qf)), mod.pack2(jnp.asarray(kf)),
                 jnp.concatenate([mod.pack2(jnp.asarray(vf)), jnp.ones((8, 512, 1), jnp.bfloat16)],
                                 axis=-1))
    want = np.asarray(mod.build(mode)(*jargs))
    targs = probes.fp32_inputs(*(torch.from_numpy(x) for x in (qf, kf, vf)), mode)
    for j, t in zip(jargs, targs):  # the same operands, packed on either side
        np.testing.assert_array_equal(np.asarray(j.astype(jnp.float32)), t.float().numpy())
    got = probes.probe_fp32(mode, *targs)
    assert got.dtype == torch.float32 and tuple(got.shape) == (8, 512, 64)
    if mode != "bf16_skel":
        np.testing.assert_array_equal(want[..., :64], want[..., 64:])
    assert _rel(got, want[..., :64]) <= (BF16_TOL if mode == "bf16_skel" else FP32_TOL)
