"""Block-sparse masks in the port against the JAX package.

``BlockMask.from_mask_fn``'s tables and errors against the JAX package's for
the four mask families of ``tests/test_block_mask.py`` (at 512 tokens with
128-token blocks); the kernels' own tile tables, walked as the CUDA kernels
walk them, against the dense mask; the forward against the JAX forward (its
Pallas kernel in interpret mode on the CPU, ``precision="float32"``) over
every family in float32 and bfloat16 (``tests/test_block_mask.py``'s bounds,
2e-5 and 2e-2); the composition with segment ids and ``save_residuals``
through ``attention()``; a ragged S_q = S_kv = 300 through ``attention()``
with the mask built at the padded 384; gradients through ``attention()``
under autograd against ``jax.grad`` of the JAX ``attention()`` (5e-4); the
block-mask backward against the segment-id backward for a document mask;
and the bf16 route, which on the card runs the tensor-core forms
(``ops.flash.kernel_form``, over their own tiles, walked longest first):
its rounding (``form="tc"``), and its output and gradients through
``attention()`` against the JAX package's in bf16 (2e-2) for prefix-LM,
document and strided masks and a ragged S.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashattention_tpu as fj
import flashattention_tpu_torch as ft
from flashattention_tpu.ops import flash as jflash
from flashattention_tpu_torch.ops import backward as tbwd
from flashattention_tpu_torch.ops import flash as tflash
from flashattention_tpu_torch.utils.testing import to_numpy, validate_result

torch.set_num_threads(2)

FWD_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = 5e-4
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
S, BLOCK = 512, 128


# The families of tests/test_block_mask.py, at half the length.  Dual-use:
# numpy ints (host classification), jnp and torch ints (element masks).
def causal_fn(r, c):
    return c <= r


def prefix_lm_fn(r, c):
    return (c < 128) | (c <= r)


def strided_fn(r, c):
    return (abs(r - c) < 64) | (c % 128 == 0)


def document_fn(r, c):
    return (r // 128) == (c // 128)


FAMILIES = [causal_fn, prefix_lm_fn, strided_fn, document_fn]


def _rand(rng, shape, dt="float32"):
    x = rng.standard_normal(shape).astype(np.float32)
    return to_numpy(torch.tensor(x).to(TDT[dt]).float())


def _masks(fn, s=S, block=BLOCK):
    return (jflash.BlockMask.from_mask_fn(fn, s, s, block_q=block, block_kv=block),
            tflash.BlockMask.from_mask_fn(fn, s, s, block_q=block, block_kv=block))


@pytest.mark.parametrize("fn", FAMILIES, ids=lambda f: f.__name__)
def test_tables_match_jax(fn):
    jm, tm = _masks(fn)
    for field in ("s_q", "s_kv", "block_q", "block_kv", "qi", "kj", "first_kj", "last_kj",
                  "needs_element_mask", "element_live_fraction", "num_pairs", "live_fraction",
                  "occupancy"):
        assert getattr(tm, field) == getattr(jm, field), field
    assert tm.mask_fn is fn


def _starved(r, c):
    return (r < 256) & (c <= r)


def _row_only(r, c):
    return r >= 0


@pytest.mark.parametrize("fn, s, match", [
    (_starved, 512, "no live key"),
    (causal_fn, 320, "multiples of the mask block sizes"),
    (_row_only, 256, "must broadcast"),
], ids=["starved_row", "non_multiple", "broadcast"])
def test_errors_match_jax(fn, s, match):
    for cls in (jflash.BlockMask, tflash.BlockMask):
        with pytest.raises(ValueError, match=match) as info:
            cls.from_mask_fn(fn, s, s, block_q=256, block_kv=256)
        if cls is jflash.BlockMask:
            want = str(info.value)
    assert str(info.value) == want


@pytest.mark.parametrize("tile_q, tile_kv, fn", [
    pytest.param(64, 32, strided_fn, id="64-32"),
    pytest.param(32, 32, strided_fn, id="32-32"),
    pytest.param(16, 16, strided_fn, id="16-16"),
    pytest.param(64, 64, strided_fn, id="64-64"),
    # The tensor-core forms' tiles: the forward's at d = 64 / 128 and dQ's
    # (and the forward's at d = 256), and dK/dV's.  Each 128-key tile holds
    # a strided column, so these take the prefix-LM mask, which leaves dead,
    # full and partial tiles there.
    pytest.param(128, 128, prefix_lm_fn, id="128-128"),
    pytest.param(128, 64, prefix_lm_fn, id="128-64"),
    pytest.param(64, 128, prefix_lm_fn, id="64-128"),
])
def test_kernel_tiles_cover_the_mask(tile_q, tile_kv, fn):
    """Walk the kernels' tables as the CUDA kernels do (by query tile and,
    transposed, by key tile): live tiles' element bits, full tiles' ones,
    and nothing else, rebuild the dense mask exactly."""
    bm = tflash.BlockMask.from_mask_fn(fn, S, S, block_q=BLOCK, block_kv=BLOCK)
    dense = np.asarray(fn(np.arange(S)[:, None], np.arange(S)[None, :]))
    t = bm.tiles(tile_q, tile_kv, "cpu")
    words = -(-tile_kv // 32)
    bits = t.bits.numpy().view(np.uint32).reshape(-1, tile_q, words)
    for ptr, idx, part, by_q in ((t.row_ptr, t.row_idx, t.row_part, True),
                                 (t.col_ptr, t.col_idx, t.col_part, False)):
        got = np.zeros_like(dense)
        for a in range(len(ptr) - 1):
            for e in range(int(ptr[a]), int(ptr[a + 1])):
                i, j = (a, int(idx[e])) if by_q else (int(idx[e]), a)
                rows, cols = slice(i * tile_q, (i + 1) * tile_q), slice(j * tile_kv, (j + 1) * tile_kv)
                slot = int(part[e])
                if slot < 0:
                    got[rows, cols] = True
                else:
                    w = bits[slot]
                    c = np.arange(tile_kv)
                    got[rows, cols] = (w[:, c // 32] >> (c % 32).astype(np.uint32)) & 1
        np.testing.assert_array_equal(got, dense)
    n_live = len(t.row_idx)
    assert n_live == len(t.col_idx) < (S // tile_q) * (S // tile_kv)
    assert 0 < int((t.row_part >= 0).sum()) < n_live  # partial tiles and full ones
    assert bm.tiles(tile_q, tile_kv, "cpu") is t  # classified once, cached


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("fn", FAMILIES, ids=lambda f: f.__name__)
def test_forward_matches_jax(fn, dt):
    rng = np.random.default_rng(7)
    q, k, v = (_rand(rng, (2, S, 64), dt) for _ in range(3))
    jm, tm = _masks(fn)
    want = jflash.flash_attention(*(jnp.asarray(x, JDT[dt]) for x in (q, k, v)), block_mask=jm,
                                  scale=0.125, precision="float32", interpret=True)
    got = tflash.flash_attention(*(torch.tensor(x).to(TDT[dt]) for x in (q, k, v)), block_mask=tm,
                                 scale=0.125)
    validate_result(got, np.asarray(want, np.float32), FWD_TOL[dt])


def test_segments_and_residuals_through_attention_match_jax():
    rng = np.random.default_rng(11)
    q, k, v = (_rand(rng, (2, 1, S, 64)) for _ in range(3))
    seg = np.zeros((2, S), np.int32)
    seg[:, S // 2:] = 1
    jm, tm = _masks(prefix_lm_fn)
    jo, jl, jmx = fj.attention(*(jnp.asarray(x) for x in (q, k, v)), block_mask=jm,
                               q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg),
                               save_residuals=True, precision="float32", interpret=True)
    to, tl, tmx = ft.attention(*(torch.tensor(x) for x in (q, k, v)), block_mask=tm,
                               q_segment_ids=torch.tensor(seg), kv_segment_ids=torch.tensor(seg),
                               save_residuals=True)
    validate_result(to, np.asarray(jo), FWD_TOL["float32"], name="o")
    validate_result(tl, np.asarray(jl), 1e-4, name="l")
    validate_result(tmx, np.asarray(jmx), 1e-5, name="m")


def test_ragged_attention_with_padded_mask_matches_jax():
    """S = 300: the mask is built at the padded 384, as the JAX attention()
    requires; the port's kernels mask the ragged edge instead of padding."""
    rng = np.random.default_rng(5)
    s = 300
    q, k, v = (_rand(rng, (1, 2, s, 64)) for _ in range(3))
    jm, tm = _masks(strided_fn, s=384)
    want = fj.attention(*(jnp.asarray(x) for x in (q, k, v)), block_mask=jm, scale=0.125,
                        precision="float32", interpret=True)
    got = ft.attention(*(torch.tensor(x) for x in (q, k, v)), block_mask=tm, scale=0.125)
    validate_result(got, np.asarray(want), FWD_TOL["float32"])
    with pytest.raises(ValueError, match="padded"):
        ft.attention(*(torch.tensor(x) for x in (q, k, v)), block_mask=_masks(strided_fn)[1])


@pytest.mark.parametrize("fn", [prefix_lm_fn, document_fn], ids=lambda f: f.__name__)
def test_gradients_through_attention_match_jax(fn):
    rng = np.random.default_rng(21)
    q, k, v, t = (_rand(rng, (1, 2, S, 64)) for _ in range(4))
    jm, tm = _masks(fn)

    def j_loss(q, k, v):
        o = fj.attention(q, k, v, block_mask=jm, precision="float32", interpret=True)
        return jnp.sum(o * t)

    jgrads = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    targs = [torch.tensor(x).requires_grad_() for x in (q, k, v)]
    tgrads = torch.autograd.grad((ft.attention(*targs, block_mask=tm) * torch.tensor(t)).sum(),
                                 targs)
    for name, g_, w in zip(("dq", "dk", "dv"), tgrads, jgrads):
        validate_result(g_, np.asarray(w), GRAD_TOL, name=f"{fn.__name__} {name}")


def test_document_mask_backward_equals_segments_backward():
    """A document mask is segment ids in another form: the block-mask
    backward (two-pass) gives the segment-id backward's gradients, both in
    exact float32 (``precision="float32"``: the pair under a block mask is
    exact in every mode, the segment-id pair's default is JAX's
    "bf16_3x")."""
    rng = np.random.default_rng(33)
    q, k, v, t = (torch.tensor(_rand(rng, (1, S, 64))) for _ in range(4))
    bm = tflash.BlockMask.from_mask_fn(document_fn, S, S, block_q=256, block_kv=256)
    o, l, m = tflash.flash_attention(q, k, v, block_mask=bm, save_residuals=True)
    lse = m + torch.log(torch.where(l == 0.0, 1.0, l))
    got = tbwd.flash_attention_bwd(q, k, v, o, lse, t, block_mask=bm, precision="float32")
    seg = (torch.arange(S) // 128).to(torch.int32)[None, :]
    want = tbwd.flash_attention_bwd(q, k, v, o, lse, t, q_segment_ids=seg, kv_segment_ids=seg,
                                    precision="float32")
    for name, g_, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g_).all()
        validate_result(g_, to_numpy(w), 1e-5, name=f"{name} vs segments")


def test_block_mask_refusals():
    """JAX's errors: causal or a window with a mask, the GQA fold, other
    lengths, the fused backward; the xla route has no masked oracle."""
    x = torch.zeros(1, 256, 32)
    bm = tflash.BlockMask.from_mask_fn(causal_fn, 256, 256, block_q=128, block_kv=128)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tflash.flash_attention(x, x, x, causal=True, block_mask=bm)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ft.attention(x, x, x, causal=True, block_mask=bm)
    with pytest.raises(ValueError, match="GQA row fold"):
        ft.attention(torch.zeros(1, 2, 256, 32), torch.zeros(1, 1, 256, 32),
                     torch.zeros(1, 1, 256, 32), block_mask=bm)
    with pytest.raises(ValueError, match="built for"):
        tflash.flash_attention(torch.zeros(1, 384, 32), x, x, block_mask=bm)
    lse = torch.zeros(1, 256)
    with pytest.raises(ValueError, match="fused backward does not support block_mask"):
        tbwd.flash_attention_bwd(x, x, x, x, lse, x, block_mask=bm, fused=True)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tbwd.flash_attention_bwd(x, x, x, x, lse, x, block_mask=bm, causal=True)
    with pytest.raises(NotImplementedError, match="block_mask"):
        ft.attention(x, x, x, block_mask=bm, implementation="xla")


@pytest.mark.parametrize("tile_q, tile_kv", [(64, 128), (64, 64)])
@pytest.mark.parametrize("fn", [prefix_lm_fn, strided_fn, document_fn], ids=lambda f: f.__name__)
def test_kv_row_bits_cover_the_mask(fn, tile_q, tile_kv):
    """The tensor-core dK/dV form's table (``tc_by_kv``): its key tiles'
    live query tiles, with each partial tile's bits read by key row from
    ``bits_t``, as the kernel reads them, rebuild the dense mask."""
    bm = tflash.BlockMask.from_mask_fn(fn, S, S, block_q=BLOCK, block_kv=BLOCK)
    dense = np.asarray(fn(np.arange(S)[:, None], np.arange(S)[None, :]))
    t = bm.tiles(tile_q, tile_kv, "cpu")
    bits_t = t.bits_t.numpy().view(np.uint32).reshape(-1, tile_kv, -(-tile_q // 32))
    assert t.tc_by_kv()[3] == t.bits_t.data_ptr()
    got = np.zeros_like(dense)
    r = np.arange(tile_q)
    for kt in range(S // tile_kv):
        for e in range(int(t.col_ptr[kt]), int(t.col_ptr[kt + 1])):
            qt, slot = int(t.col_idx[e]), int(t.col_part[e])
            rows = slice(qt * tile_q, (qt + 1) * tile_q)
            cols = slice(kt * tile_kv, (kt + 1) * tile_kv)
            if slot < 0:
                got[rows, cols] = True
            else:  # key row c's words over the query rows
                got[rows, cols] = ((bits_t[slot][:, r // 32] >> (r % 32).astype(np.uint32)) & 1).T
    np.testing.assert_array_equal(got, dense)


# The tensor-core forms' route in bf16: masks at 256 tokens, head_dim 64
# (the forward's (128, 128) tiles, dQ's (128, 64), dK/dV's (64, 128)); the
# ragged case at S = 200 with the strided mask built at the padded 256.
TC_S = 256
TC_CASES = [("prefix_lm", prefix_lm_fn, TC_S), ("documents", document_fn, TC_S),
            ("strided", strided_fn, TC_S), ("strided_ragged_s200", strided_fn, 200)]
TC_TOL = 2e-2


def _tc_inputs(seed, s):
    rng = np.random.default_rng(seed)
    q, k, v = (_rand(rng, (1, 2, s, 64), "bfloat16") for _ in range(3))
    t = _rand(rng, (1, 2, s, 64), "bfloat16") * np.float32(0.25)
    return q, k, v, t


def test_bf16_route_takes_the_tc_rounding():
    """On CPU tensors the bf16 route with a block mask is the tensor-core
    forms' plain version (P, and dS, as two bf16 terms; P against the
    running max of 128-key tiles), which differs from the scalar form's by
    no more than bf16 rounding."""
    q, k, v, t = (torch.tensor(x[0]).to(torch.bfloat16) for x in _tc_inputs(3, TC_S))
    bm = tflash.BlockMask.from_mask_fn(strided_fn, TC_S, TC_S, block_q=BLOCK, block_kv=BLOCK)
    for kernel in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert tflash.kernel_form(kernel, torch.bfloat16, 64, block_mask=True) == "tc"
    o, l, m = tflash.flash_attention(q, k, v, block_mask=bm, save_residuals=True)
    tc = tflash.flash_attention_plain(q, k, v, block_mask=bm, form="tc")
    scalar = tflash.flash_attention_plain(q, k, v, block_mask=bm, form="scalar")
    assert torch.equal(o, tc)
    assert 0.0 < float((tc.float() - scalar.float()).abs().max()) < TC_TOL
    lse = m + torch.log(l)
    got = tbwd.flash_attention_bwd(q, k, v, o, lse, t, block_mask=bm)
    want = tbwd.flash_attention_bwd_plain(q, k, v, o, lse, t, block_mask=bm, form="tc")
    other = tbwd.flash_attention_bwd_plain(q, k, v, o, lse, t, block_mask=bm, form="scalar")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert max(float((a.float() - b.float()).abs().max()) for a, b in zip(want, other)) > 0.0


@pytest.mark.parametrize("name, fn, s", TC_CASES, ids=[c[0] for c in TC_CASES])
def test_bf16_tc_route_through_attention_matches_jax(name, fn, s):
    """bf16 output and gradients through ``attention(block_mask=)`` under
    autograd, in the tensor-core forms' rounding, against the JAX
    ``attention()`` and ``jax.grad`` of it in bf16 (Pallas kernels in
    interpret mode) within 2e-2."""
    q, k, v, t = _tc_inputs(41, s)
    jm, tm = _masks(fn, s=TC_S)

    def j_loss(q, k, v):
        o = fj.attention(q, k, v, block_mask=jm, interpret=True)
        return jnp.sum(o.astype(jnp.float32) * t), o

    jargs = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    jgrads, jo = jax.grad(j_loss, argnums=(0, 1, 2), has_aux=True)(*jargs)
    targs = [torch.tensor(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    to = ft.attention(*targs, block_mask=tm)
    tgrads = torch.autograd.grad((to.float() * torch.tensor(t)).sum(), targs)
    validate_result(to.detach(), np.asarray(jo, np.float32), TC_TOL, name=f"{name} o")
    for gname, g_, w in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert g_.dtype == torch.bfloat16
        validate_result(g_, np.asarray(w, np.float32), TC_TOL, name=f"{name} {gname}")
