"""Differential tests of the port's Mixtral-class MoE against the JAX package.

``tests/test_moe.py``'s configuration (2 layers, d_model 64, 4 experts,
top-2) in float32, as the JAX MoE tests run it: in bfloat16 a one-ulp
difference of the router logits can flip a route near a tie.  The JAX
parameters cross to the port through numpy (``params_from_jax``); the JAX
side runs its jnp paths and its Pallas kernels in interpret mode on the
CPU, the port its kernels' plain versions.

- ``_mlp`` against the JAX ``_mlp`` and ``test_moe.py``'s manual per-token
  loop (atol 1e-5); router logits with exact ties pick the experts
  ``lax.top_k`` picks (the lower index first);
- int8 and fp8 expert stacks: ``quantize_weights`` bit for bit, ``_mlp``
  within 1e-5;
- ``prefill`` logits within 1e-4; the engine's greedy tokens equal the JAX
  engine's, whole-prompt, chunked, multi-step and speculative;
- ``make_train_step`` and ``make_train_step_packed`` on MoE: losses and
  updated parameters against JAX's 1x1-mesh steps within 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flashattention_tpu.models import transformer as jt
from flashattention_tpu.models.train import make_train_step as j_make_train_step
from flashattention_tpu.models.train import make_train_step_packed as j_make_train_step_packed
from flashattention_tpu.models.train import shard_params
from flashattention_tpu.ops import quant as jquant
from flashattention_tpu.runtime import engine as je
from flashattention_tpu.runtime import kvcache as jk
from flashattention_tpu_torch.models import train as ttrain
from flashattention_tpu_torch.models import transformer as tt
from flashattention_tpu_torch.ops import quant as tquant
from flashattention_tpu_torch.runtime import engine as te
from flashattention_tpu_torch.runtime import kvcache as tk
from flashattention_tpu_torch.utils import packing as tpacking
from flashattention_tpu_torch.utils.testing import to_numpy, validate_result

torch.set_num_threads(2)

MLP_TOL = 1e-5
LOGIT_TOL = 1e-4
TRAIN_TOL = 1e-5
LR = 1e-2
FIELDS = dict(vocab_size=64, num_layers=2, d_model=64, num_q_heads=4, num_kv_heads=2,
              head_dim=32, intermediate=64, dtype="float32", num_experts=4,
              experts_per_token=2)


def _models(**kw):
    fields = {**FIELDS, **kw}
    jcfg, tcfg = jt.ModelConfig(**fields), tt.ModelConfig(**fields)
    jp = jt.init_params(jax.random.key(0), jcfg)
    tp = tt.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models():
    return _models()


def _x(seed, shape=(2, 8, 64)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_init_params_layout_matches_jax(models):
    """The port's MoE tree has the JAX tree's names, shapes and dtypes, and
    ``params_from_jax`` carries the router and the expert stacks."""
    jcfg, tcfg, jp, tp = models
    mine = tt.init_params(0, tcfg, device="cpu")
    for jl, tl, ml in zip(jp["layers"], tp["layers"], mine["layers"]):
        assert set(jl) == set(tl) == set(ml) and "router" in jl
        for name in jl:
            assert tuple(tl[name].shape) == tuple(ml[name].shape) == jl[name].shape, name
            assert ml[name].dtype == torch.float32
            np.testing.assert_array_equal(to_numpy(tl[name]), np.asarray(jl[name]), err_msg=name)
    assert tuple(mine["layers"][0]["w_down"].shape) == (4, 64, 64)
    assert tuple(mine["layers"][0]["router"].shape) == (64, 4)


def test_mlp_matches_jax_and_manual(models):
    """``_mlp`` against the JAX ``_mlp`` and ``test_moe.py``'s manual
    per-token top-k combination."""
    _, tcfg, jp, tp = models
    x = _x(1)
    layer = tp["layers"][0]
    got = tt._mlp(torch.from_numpy(x), layer, tcfg.experts_per_token)
    want = np.asarray(jt._mlp(jnp.asarray(x), jp["layers"][0], tcfg.experts_per_token))
    validate_result(got, want, MLP_TOL, name="mlp vs jax")

    xt = torch.from_numpy(x)
    logits = xt @ layer["router"]
    wk, idx = tt._top_k(logits, tcfg.experts_per_token)
    wk = torch.softmax(wk, dim=-1)
    manual = torch.zeros_like(xt)
    for b in range(2):
        for s in range(8):
            h = xt[b, s]
            for j in range(tcfg.experts_per_token):
                e = int(idx[b, s, j])
                gate = torch.nn.functional.silu(h @ layer["w_gate"][e])
                manual[b, s] += wk[b, s, j] * ((gate * (h @ layer["w_up"][e])) @ layer["w_down"][e])
    validate_result(got, manual, MLP_TOL, name="mlp vs manual")


TIES = {
    # router column pattern (columns equal to one another tie exactly)
    "all_equal": [0, 0, 0, 0],
    "kth_place": [1, 0, 0, 2],  # expert 0 first, 3 last: the tied 1 and 2 meet at place k
    "top_pair": [0, 0, 1, 2],
    "two_pairs": [0, 1, 0, 1],
}


@pytest.mark.parametrize("pattern", list(TIES), ids=list(TIES))
def test_router_ties_pick_lax_top_k_experts(pattern):
    """Router logits with exact ties (equal router columns): the port picks
    the experts ``lax.top_k`` picks, the lower index first, and ``_mlp``
    agrees with JAX's."""
    jcfg, tcfg, jp, _ = _models()
    cols = TIES[pattern]
    base = np.asarray(jp["layers"][0]["router"])
    router = np.stack([base[:, c] for c in cols], axis=1)
    if pattern == "kth_place":  # over x >= 0: column 0 far first, column 3 far last
        router[:, 0] = np.abs(router[:, 0]) * 100.0
        router[:, 3] = -np.abs(router[:, 3]) * 100.0
    jl = dict(jp["layers"][0], router=jnp.asarray(router))
    tl = tt.params_from_jax({"embed": np.zeros((1, 1)), "final_norm": np.zeros(1),
                             "lm_head": np.zeros((1, 1)),
                             "layers": [jax.tree.map(np.asarray, jl)]}, device="cpu")["layers"][0]
    x = np.abs(_x(2)) if pattern == "kth_place" else _x(2)
    jlog = jnp.asarray(x) @ jl["router"]
    _, jidx = jax.lax.top_k(jlog, tcfg.experts_per_token)
    tlog = torch.from_numpy(x) @ tl["router"]
    for log in (to_numpy(tlog), np.asarray(jlog)):  # the ties are exact on both sides
        for a, b in {"all_equal": [(0, 1), (0, 3)], "kth_place": [(1, 2)],
                     "top_pair": [(0, 1)], "two_pairs": [(0, 2), (1, 3)]}[pattern]:
            np.testing.assert_array_equal(log[..., a], log[..., b])
    _, tidx = tt._top_k(tlog, tcfg.experts_per_token)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    if pattern in ("all_equal", "kth_place"):  # the tie decides every token's route
        assert (tidx.numpy() == [0, 1]).all()
    if pattern == "top_pair":  # where the pair leads, 0 before 1
        lead = (tidx.numpy() == 0).any(-1) & (tidx.numpy() == 1).any(-1)
        assert lead.any() and (tidx.numpy()[lead] == [0, 1]).all()
    got = tt._mlp(torch.from_numpy(x), tl, tcfg.experts_per_token)
    want = np.asarray(jt._mlp(jnp.asarray(x), jl, tcfg.experts_per_token))
    validate_result(got, want, MLP_TOL, name=f"mlp with ties ({pattern})")


def test_top_k_prefers_the_lower_index():
    logits = torch.tensor([[1.0, 3.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0, 2.0],
                           [0.0, -1.0, 0.0, 5.0, -1.0]])
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 3)
    tv, ti = tt._top_k(logits, 3)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[1, 2, 3], [0, 1, 2], [3, 0, 2]]


@pytest.mark.parametrize("dtype", ["int8", "fp8"])
def test_quantized_expert_stacks_match_jax(models, dtype):
    """``quantize_weights`` over a MoE tree: every payload and scale bit for
    bit the JAX package's (3-D stacks: scales ``(E, d_out)``), the router
    left as it is; ``params_from_jax`` carries the quantized stacks; ``_mlp``
    on them within 1e-5 of the JAX one."""
    _, tcfg, jp, tp = models
    jq = jquant.quantize_weights(jp, dtype)
    tq = tquant.quantize_weights(tp, dtype)
    carried = tt.params_from_jax(jax.tree.map(np.asarray, jq), device="cpu")
    for jl, tl, cl in zip(jq["layers"], tq["layers"], carried["layers"]):
        assert torch.is_tensor(tl["router"]) and torch.is_tensor(cl["router"])
        for name in ("w_gate", "w_up", "w_down", "wq", "wo"):
            j, t, c = jl[name], tl[name], cl[name]
            assert isinstance(t, tquant.QuantizedWeight) and isinstance(c, tquant.QuantizedWeight)
            assert tuple(t.scales.shape) == j.scales.shape
            for w in (t, c):
                assert w.payload.dtype == tquant.QUANT_DTYPES[dtype][0]
                np.testing.assert_array_equal(to_numpy(w.payload), np.asarray(j.payload, np.float32))
                np.testing.assert_array_equal(to_numpy(w.scales), np.asarray(j.scales))
    assert tuple(tq["layers"][0]["w_gate"].scales.shape) == (4, 64)
    x = _x(3)
    got = tt._mlp(torch.from_numpy(x), tq["layers"][0], tcfg.experts_per_token)
    want = np.asarray(jt._mlp(jnp.asarray(x), jq["layers"][0], tcfg.experts_per_token))
    validate_result(got, want, MLP_TOL, name=f"mlp over {dtype} stacks")


def test_prefill_matches_jax(models):
    jcfg, tcfg, jp, tp = models
    toks = np.random.default_rng(4).integers(0, 64, (2, 24)).astype(np.int32)
    lj, kj, vj = jt.prefill(jp, jnp.asarray(toks), cfg=jcfg)
    lt, kt, vt = tt.prefill(tp, torch.from_numpy(toks), tcfg)
    validate_result(lt, np.asarray(lj), LOGIT_TOL, name="logits")
    validate_result(kt, np.asarray(kj), LOGIT_TOL, name="k rows")
    validate_result(vt, np.asarray(vj), LOGIT_TOL, name="v rows")


PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [7, 7, 7], list(range(5, 45)))


def _engines(models, chunk):
    jcfg, tcfg, jp, tp = models
    cache = dict(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8, num_pages=32,
                 dtype="float32")
    ecfg = dict(max_batch=2, pages_per_seq=8, prefill_chunk=chunk)
    return (je.Engine(jp, jcfg, jk.CacheConfig(**cache), je.EngineConfig(**ecfg)),
            te.Engine(tp, tcfg, tk.CacheConfig(**cache), te.EngineConfig(**ecfg), device="cpu"))


@pytest.mark.parametrize("mode", ["whole", "chunked", "multi_step", "speculative"])
def test_engine_greedy_matches_jax(models, mode):
    """The MoE model through both engines (``test_moe.py:61``): greedy
    tokens identical, whole-prompt, chunked (a 40-token prompt in chunks of
    16), ``run(multi_step=4)`` and ``run_speculative(k=4)`` with drafts that
    are half right; every page free afterwards."""
    chunk = 16 if mode == "chunked" else 0
    outs = []
    for eng in _engines(models, chunk):
        ids = [eng.add_request(p, 6) for p in PROMPTS]
        outs.append((ids, eng.run()))
    (ids, want), (_, plain) = outs
    assert plain == want
    if mode in ("whole", "chunked"):
        return
    truth = {rid: p + want[rid] for rid, p in zip(ids, PROMPTS)}

    def half_right(req, n):
        right = truth[req.req_id][req.length: req.length + n]
        return [t if j % 2 == 0 else (t + 1) % 64 for j, t in enumerate(right)]

    for eng in _engines(models, 0):
        for p in PROMPTS:
            eng.add_request(p, 6)
        got = eng.run(multi_step=4) if mode == "multi_step" else eng.run_speculative(half_right, k=4)
        assert got == want, type(eng)
        assert eng.cache.num_free_pages() == 32


def _jax_step_model():
    jcfg = jt.ModelConfig(**FIELDS)
    raw = jt.init_params(jax.random.key(0), jcfg)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))
    tp = tt.params_from_jax(jax.tree.map(np.asarray, raw), device="cpu")
    return jcfg, mesh, shard_params(raw, mesh, jcfg), tp


def check_trees(jparams, tparams, tol):
    for name in ("embed", "final_norm", "lm_head"):
        validate_result(tparams[name], np.asarray(jparams[name]), tol, name=name)
    for i, (tl, jl) in enumerate(zip(tparams["layers"], jparams["layers"])):
        assert sorted(tl) == sorted(jl)
        for name in tl:
            validate_result(tl[name], np.asarray(jl[name]), tol, name=f"layers.{i}.{name}")


@pytest.mark.parametrize("packed", [False, True], ids=["plain", "packed"])
def test_train_step_matches_jax(packed):
    """Three SGD steps on the MoE model: losses and updated parameters (the
    router and expert stacks among them) within 1e-5 of the JAX steps' on a
    1x1 mesh."""
    jcfg, mesh, jparams, tparams = _jax_step_model()
    tcfg = tt.ModelConfig(**FIELDS)
    rng = np.random.default_rng(5)
    if packed:
        docs = [rng.integers(0, 64, n) for n in (50, 30, 20, 60)]
        args = tpacking.pack_documents(docs, 128)
    else:
        args = (rng.integers(0, 64, (2, 128)).astype(np.int32),)
    sharding = NamedSharding(mesh, P("dp", None))
    jargs = [jax.device_put(jnp.asarray(a), sharding) for a in args]
    targs = [torch.from_numpy(np.asarray(a)) for a in args]
    make_j = j_make_train_step_packed if packed else j_make_train_step
    make_t = ttrain.make_train_step_packed if packed else ttrain.make_train_step
    jstep, tstep = make_j(mesh, jcfg, lr=LR), make_t(tcfg, lr=LR, device="cpu")
    for _ in range(3):
        jloss, jparams = jstep(jparams, *jargs)
        tloss, tparams = tstep(tparams, *targs)
        assert abs(float(tloss) - float(jloss)) <= TRAIN_TOL * abs(float(jloss))
    check_trees(jparams, tparams, TRAIN_TOL)
    assert not np.array_equal(to_numpy(tparams["layers"][0]["router"]),
                              np.asarray(_jax_step_model()[2]["layers"][0]["router"]))


def test_moe_layer_dataclass_matches_preset():
    """``mixtral8x7b``'s fields are the JAX preset's and FIELDS' MoE
    fields; a float32 cut of it at FIELDS' widths keeps 8 experts, top-2."""
    cfg = dataclasses.replace(tt.ModelConfig.mixtral8x7b(), **{
        k: v for k, v in FIELDS.items() if k not in ("num_experts", "experts_per_token")})
    assert (cfg.num_experts, cfg.experts_per_token) == (8, 2)
    assert dataclasses.asdict(tt.ModelConfig.mixtral8x7b()) == dataclasses.asdict(
        jt.ModelConfig.mixtral8x7b())
    params = tt.init_params(1, cfg, device="cpu")
    assert tuple(params["layers"][1]["w_up"].shape) == (8, 64, 64)
