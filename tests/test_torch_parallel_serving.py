"""The port's DP x TP sharded serving (``flashattention_tpu_torch/parallel/
serving.py`` on ``torch.distributed``) against the JAX package's
(``flashattention_tpu/parallel/serving.py`` on the 8-device CPU mesh).

One spawn of 4 gloo ranks (dp = 2 x tp = 2, TP groups {0, 1} and {2, 3};
``tests/_torch_sharded_ranks.py``) per module runs every case on the CPU;
each rank cuts its shards out of the same global inputs (``local_shard``,
``shard_params``), and the parent puts the shards back together:

- ``param_specs`` names JAX's split for every leaf, dense and MoE, and
  ``shard_params(params_from_jax(p))`` is bit for bit each device's shard of
  JAX's ``shard_params`` on a 4 x 2 mesh;
- sharded paged attention (float32, bf16 and int8 pools) against JAX's
  ``make_sharded_paged_attention``: float32 within 1e-5, bf16 within 2e-2,
  int8 within 2e-2 of the output's magnitude (the bound at which
  ``tests/test_torch_quant.py`` holds the port's 8-bit paged decode);
- the sharded decode step (dense, MoE top-2, a windowed, softcapped GQA
  model, and the dense model over an int8 cache) against JAX's
  ``make_sharded_decode_step`` on a 2 x 2 mesh and against the single-device
  ``decode_step``: logits within 1e-3 and pools within 1e-5
  (``tests/test_parallel.py:208-209``), over the int8 cache logits within
  2e-2 of their magnitude and pools as ``tests/test_torch_quant.py``'s
  quantized decode-step differential holds them; TP peers' logits bit for
  bit equal;
- a TP group of one gives ``decode_step``'s logits and pools bit for bit,
  and a TP group that does not divide the KV heads raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_sharded_ranks as ranks
from flashattention_tpu.models import transformer as jt
from flashattention_tpu.models.train import param_specs as jparam_specs
from flashattention_tpu.models.train import shard_params as jshard_params
from flashattention_tpu.ops import quant as jq
from flashattention_tpu.ops.decode import paged_attention as jpaged_attention
from flashattention_tpu.parallel import serving as js
from flashattention_tpu_torch.models import transformer as tt
from flashattention_tpu_torch.models.train import common as tc
from flashattention_tpu_torch.parallel import serving as ts
from flashattention_tpu_torch.utils.testing import validate_result

torch.set_num_threads(2)

DP, TP = 2, 2
QUANT_TOL = 2e-2  # tests/test_torch_quant.py's bound, of the output's magnitude
BASE = dict(vocab_size=64, num_layers=2, d_model=32, num_q_heads=4, num_kv_heads=2, head_dim=16,
            intermediate=32, dtype="float32")  # tests/test_parallel.py:140-149
CONFIGS = {
    "dense": BASE,
    "moe": dict(BASE, num_experts=4, experts_per_token=2),
    "window_softcap_gqa": dict(BASE, num_q_heads=8, num_kv_heads=4, sliding_window=6,
                               logit_softcap=20.0),
}
STEP_CASES = {"dense": ("dense", False), "moe": ("moe", False),
              "window_softcap_gqa": ("window_softcap_gqa", False), "dense_int8": ("dense", True)}
ATTN_CASES = ("float32", "bfloat16", "int8")
PS, P_LOCAL = 8, 6
LOCAL_PI = np.array([[0, 1], [2, 3], [0, 1], [2, 3]], np.int32)  # two requests per dp slice
GLOBAL_PI = LOCAL_PI + np.repeat([0, P_LOCAL], 2)[:, None]
LENGTHS = np.array([5, 9, 12, 3], np.int32)  # including the current token


def _mesh(dp=DP, tp=TP):
    return Mesh(np.array(jax.devices()[: dp * tp]).reshape(dp, tp), ("dp", "tp"))


def _jparams(name, seed=0):
    cfg = jt.ModelConfig(**CONFIGS[name])
    return cfg, jax.tree.map(np.asarray, jt.init_params(jax.random.key(seed), cfg))


def _rows(rng, shape):
    """Normal rows whose magnitudes spread over two decades."""
    mag = 10.0 ** rng.uniform(-1, 1, shape[:-1] + (1,))
    return (rng.standard_normal(shape) * mag).astype(np.float32)


def _quantized(x):
    """``x`` (..., ps, d) quantized per row by the JAX package: int8
    payload and float32 scales, numpy."""
    qt = jq.quantize(jnp.asarray(x.reshape(-1, *x.shape[-2:])), "int8")
    return (np.asarray(qt.payload).reshape(x.shape), np.asarray(qt.scales).reshape(x.shape[:-1]))


def _step_case(name, quantized, seed=1):
    cfg, params = _jparams(name)
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, DP * P_LOCAL, cfg.num_kv_heads, PS, cfg.head_dim)
    positions = LENGTHS - 1
    case = {"kind": "step", "cfg": dataclasses.asdict(cfg), "params": params,
            "tokens": rng.integers(0, cfg.vocab_size, LENGTHS.shape).astype(np.int32),
            "positions": positions, "lengths": LENGTHS, "page_indices": LOCAL_PI,
            "write_pages": LOCAL_PI[np.arange(4), positions // PS],
            "write_slots": (positions % PS).astype(np.int32)}
    if quantized:
        (case["k_pages"], case["k_scales"]), (case["v_pages"], case["v_scales"]) = (
            _quantized(_rows(rng, shape)) for _ in range(2))
    else:
        hist = rng.standard_normal(shape).astype(np.float32)
        case["k_pages"], case["v_pages"] = hist * 0.1, hist * 0.2
    return cfg, case


def _attn_case(dtype, seed=2):
    rng = np.random.default_rng(seed)
    b, kvh, g, d = 4, 4, 2, 32
    shape = (DP * P_LOCAL, kvh, PS, d)
    case = {"kind": "attention", "scale": d**-0.5, "lengths": LENGTHS, "page_indices": LOCAL_PI,
            "q": rng.standard_normal((b, kvh, g, d)).astype(np.float32)}
    if dtype == "int8":
        (case["k_pages"], case["k_scales"]), (case["v_pages"], case["v_scales"]) = (
            _quantized(_rows(rng, shape)) for _ in range(2))
        case["dtype"] = "bfloat16"
        case["q"] = np.asarray(jnp.asarray(case["q"]).astype(jnp.bfloat16).astype(jnp.float32))
    else:
        case["k_pages"], case["v_pages"] = (rng.standard_normal(shape).astype(np.float32)
                                            for _ in range(2))
        case["dtype"] = dtype
        if dtype == "bfloat16":  # values a bf16 holds exactly, passed as float32
            for k in ("q", "k_pages", "v_pages"):
                case[k] = np.asarray(jnp.asarray(case[k]).astype(jnp.bfloat16).astype(jnp.float32))
    return case


def _single_case(name="dense"):
    _, case = _step_case(name, False, seed=3)
    case = dict(case, kind="single", page_indices=GLOBAL_PI,
                write_pages=GLOBAL_PI[np.arange(4), case["positions"] // PS])
    return case


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case through one spawn of the 4 ranks: ``(cases, results by
    rank)``."""
    cases = {f"attn_{dt}": _attn_case(dt) for dt in ATTN_CASES}
    cases.update({f"step_{n}": _step_case(*spec)[1] for n, spec in STEP_CASES.items()})
    cases["single_dense"] = _single_case("dense")
    cases["single_moe"] = _single_case("moe")
    cases["indivisible"] = {"kind": "indivisible",
                            "cfg": dataclasses.asdict(jt.ModelConfig(**dict(
                                BASE, num_q_heads=3, num_kv_heads=3)))}
    return cases, ranks.spawn(cases, str(tmp_path_factory.mktemp("sharded")), DP, TP)


def _gather(parts, spec):
    """The global tensor from the 4 ranks' shards (rank i * TP + j holding
    dp part i and tp part j), along the dims ``spec`` names."""
    def cat(xs, axis):
        return np.concatenate(xs, spec.index(axis)) if axis in spec else xs[0]

    return cat([cat([parts[i * TP + j] for j in range(TP)], "tp") for i in range(DP)], "dp")


def _shard(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, P(*spec)))


# ── parameter splits ────────────────────────────────────────────────────────


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_param_specs_match_jax(name):
    cfg = jt.ModelConfig(**CONFIGS[name])
    want = jparam_specs(cfg, "tp")
    got = tc.param_specs(tt.ModelConfig(**CONFIGS[name]))

    def dim(spec):
        return tuple(spec).index("tp") if "tp" in tuple(spec) else None

    assert got["embed"] is got["lm_head"] is got["final_norm"] is None
    assert [dim(want[k]) for k in ("embed", "final_norm", "lm_head")] == [None] * 3
    assert len(got["layers"]) == len(want["layers"]) == cfg.num_layers
    for g, w in zip(got["layers"], want["layers"]):
        assert g == {k: dim(s) for k, s in w.items()}


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_shard_params_match_jax_device_shards(name):
    """Each device of a 4 x 2 mesh (all 8 CPU devices) holds, bit for bit,
    the port's ``shard_params`` of its tp index."""
    cfg, params = _jparams(name, seed=4)
    mesh = _mesh(4, 2)
    jsharded = jshard_params(jax.tree.map(jnp.asarray, params), mesh, cfg)
    tparams = tt.params_from_jax(params, device="cpu")
    mine = [tc.shard_params(tparams, tt.ModelConfig(**CONFIGS[name]), j, 2) for j in range(2)]
    flat_j = jax.tree_util.tree_flatten_with_path(jsharded)[0]
    assert len(flat_j) == len(tc.leaves(tparams))
    for path, arr in flat_j:
        keys = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        seen = 0
        for s in arr.addressable_shards:
            _, j = np.argwhere(mesh.devices == s.device)[0]
            leaf = mine[j]
            for k in keys:
                leaf = leaf[k]
            np.testing.assert_array_equal(np.asarray(s.data), leaf.numpy(), err_msg=str(keys))
            seen += 1
        assert seen == 8


# ── sharded paged attention ─────────────────────────────────────────────────


@pytest.mark.parametrize("dtype", ATTN_CASES)
def test_sharded_paged_attention_matches_jax(world, dtype):
    cases, results = world
    case = cases[f"attn_{dtype}"]
    mesh = _mesh()
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    quantized = dtype == "int8"
    pool_dt = None if quantized else jdt
    args = [_shard(mesh, jnp.asarray(case["q"]).astype(jdt), ts.Q_SPEC),
            *(_shard(mesh, jnp.asarray(case[k]).astype(pool_dt or jnp.int8), ts.POOL_SPEC)
              for k in ("k_pages", "v_pages")),
            _shard(mesh, case["lengths"], ts.VEC_SPEC),
            _shard(mesh, case["page_indices"], ts.TABLE_SPEC)]
    if quantized:
        args += [_shard(mesh, case[k], ts.SCALE_SPEC) for k in ("k_scales", "v_scales")]
    want = np.asarray(js.make_sharded_paged_attention(
        mesh, scale=case["scale"], quantized=quantized)(*args)).astype(np.float32)
    got = _gather([r[f"attn_{dtype}"]["out"] for r in results], ts.Q_SPEC)
    tol = {"float32": 1e-5, "bfloat16": 2e-2}.get(dtype, QUANT_TOL * max(1.0, np.abs(want).max()))
    validate_result(got, want, tol)
    # And against the unsharded JAX call over the global page ids.
    whole = np.asarray(jpaged_attention(
        *(jnp.asarray(a) for a in args[:4]), jnp.asarray(GLOBAL_PI), scale=case["scale"],
        **({"k_scales_pages": args[5], "v_scales_pages": args[6]} if quantized else {})))
    validate_result(got, whole.astype(np.float32), tol)


# ── the sharded decode step ─────────────────────────────────────────────────


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's sharded step on a 2 x 2 mesh and its single-device step, per
    case: ``{name: (sharded outputs, single-device outputs)}`` as numpy."""
    out = {}
    mesh = _mesh()
    for name, (model, quantized) in STEP_CASES.items():
        cfg, case = _step_case(model, quantized)
        params = jax.tree.map(jnp.asarray, case["params"])
        pools = [case[k] for k in ("k_pages", "v_pages", "k_scales", "v_scales") if k in case]
        vecs = [case[k] for k in ("tokens", "positions", "lengths")]
        step = js.make_sharded_decode_step(mesh, cfg, quantized=quantized)
        sharded = step(
            jshard_params(params, mesh, cfg), *(_shard(mesh, v, ts.VEC_SPEC) for v in vecs[:2]),
            *(_shard(mesh, p, ts.POOLS_SPEC) for p in pools[:2]),
            _shard(mesh, vecs[2], ts.VEC_SPEC), _shard(mesh, LOCAL_PI, ts.TABLE_SPEC),
            _shard(mesh, case["write_pages"], ts.VEC_SPEC),
            _shard(mesh, case["write_slots"], ts.VEC_SPEC),
            *(_shard(mesh, p, ts.SCALES_SPEC) for p in pools[2:]))
        single = jt.decode_step(
            params, *(jnp.asarray(v) for v in vecs[:2]), *(jnp.asarray(p) for p in pools[:2]),
            jnp.asarray(vecs[2]), jnp.asarray(GLOBAL_PI),
            jnp.asarray(GLOBAL_PI[np.arange(4), case["positions"] // PS]),
            jnp.asarray(case["write_slots"]), cfg=cfg,
            **({"k_scales": jnp.asarray(pools[2]), "v_scales": jnp.asarray(pools[3])}
               if quantized else {}))
        single = single[:3] + (single[3:] if quantized else ())
        out[name] = tuple([np.asarray(x).astype(np.float32) for x in o] for o in (sharded, single))
    return out


def _port_step(results, name):
    """The port's step outputs put back together: logits, pools[, scale
    pools], as float32 numpy."""
    rs = [r[f"step_{name}"] for r in results]
    logits = _gather([r["logits"] for r in rs], ts.LOGITS_SPEC)
    pools = [_gather([r[k] for r in rs], ts.POOLS_SPEC).astype(np.float32)
             for k in ("k_pages", "v_pages")]
    scales = [_gather([r[k] for r in rs], ts.SCALES_SPEC) for k in ("k_scales", "v_scales")
              if k in rs[0]]
    return [logits, *pools, *scales]


def _check_step(got, want, quantized):
    if not quantized:
        validate_result(got[0], want[0], 1e-3)
        for g, w in zip(got[1:3], want[1:3]):
            validate_result(g, w, 1e-5)
        return
    validate_result(got[0], want[0], QUANT_TOL * max(1.0, np.abs(want[0]).max()))
    # Pools as tests/test_torch_quant.py's quantized decode-step differential
    # holds them: layer 0's payloads equal but for a row on the other side of
    # a half step (at most 2 elements, one step), scales to 1e-6 of their
    # magnitude; every layer dequantized within QUANT_TOL of its magnitude.
    for pay_g, pay_w, sc_g, sc_w in zip(got[1:3], want[1:3], got[3:5], want[3:5]):
        diff = pay_g[0] != pay_w[0]
        assert diff.sum() <= 2 and np.all(np.abs(pay_g[0] - pay_w[0]) <= 1.0), diff.sum()
        validate_result(sc_g[0], sc_w[0], 1e-6 * float(np.abs(sc_w).max()))
        deq_w = pay_w * sc_w[..., None]
        validate_result(pay_g * sc_g[..., None], deq_w, QUANT_TOL * max(1.0, np.abs(deq_w).max()))


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_decode_step_matches_jax_sharded(world, jax_steps, name):
    _, results = world
    _check_step(_port_step(results, name), jax_steps[name][0], STEP_CASES[name][1])


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_sharded_decode_step_matches_single_device(world, jax_steps, name):
    _, results = world
    _check_step(_port_step(results, name), jax_steps[name][1], STEP_CASES[name][1])


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_tp_peers_logits_bitwise_equal(world, name):
    _, results = world
    for i in range(DP):
        a, b = (results[i * TP + j][f"step_{name}"]["logits"] for j in range(TP))
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(results[0][f"step_{name}"]["logits"],
                              results[TP][f"step_{name}"]["logits"])


@pytest.mark.parametrize("name", ["single_dense", "single_moe"])
def test_tp_group_of_one_is_decode_step(world, name):
    _, results = world
    for r in results:
        assert r[name] == {"bitwise": True, "group_size": 1}


def test_tp_not_dividing_kv_heads_raises(world):
    _, results = world
    for r in results:
        assert r["indivisible"]["error"] == "tp=2 must divide num_kv_heads=3"


def test_local_shard_cuts_like_named_sharding():
    """``local_shard`` gives each device's shard of a ``NamedSharding``."""
    mesh = _mesh()
    x = np.arange(2 * 12 * 4 * 3 * 2, dtype=np.float32).reshape(2, 12, 4, 3, 2)
    arr = _shard(mesh, x, ts.POOLS_SPEC)
    for s in arr.addressable_shards:
        i, j = np.argwhere(mesh.devices == s.device)[0]
        got = ts.local_shard(torch.from_numpy(x), ts.POOLS_SPEC, {"dp": (i, DP), "tp": (j, TP)})
        np.testing.assert_array_equal(got.numpy(), np.asarray(s.data))
