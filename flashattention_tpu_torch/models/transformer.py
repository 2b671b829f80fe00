"""Llama-style decoder-only transformer on the port's kernels.

Counterpart of ``flashattention_tpu/models/transformer.py``: RMSNorm + RoPE +
GQA attention + SwiGLU, with an optional sliding window (Mistral-7B-class)
and attention-score softcap (Gemma-2-9B-class, with head_dim 256), threaded
into every attention call as the JAX model threads them.  Three entry points
serve the engine:

- :func:`prefill`: whole-sequence forward on the causal flash kernel
  (``ops/flash.py`` through ``ops/dispatch.attention``), returning logits and
  every layer's K/V rows for the paged cache;
- :func:`prefill_chunk_batched` (and :func:`prefill_chunk` for one request):
  one chunk of many prompts against their paged context
  (``ops/decode.paged_prefill_attention_batched``), writing the chunk's K/V
  rows into the pools;
- :func:`decode_step`: one token for a whole continuous batch over the paged
  cache (``ops/decode.paged_attention``);
- :func:`decode_loop`: ``n_steps`` decode steps in one call, each feeding the
  token it produced back in, with no host sync between steps;
- :func:`verify_step`: speculative verification, k fed tokens per request
  scored in one pass (``paged_attention(draft_k=k)``), with
  :func:`speculative_accept` (greedy) deciding what to emit.

Parameters are a plain dict with the JAX package's tree and names
(``{"embed", "final_norm", "lm_head", "layers": [...]}``) and its ``x @ w``
weight layout, so :func:`params_from_jax` is a copy, not a transpose.  Large
matrix products stay ``torch.matmul``, as the JAX package left them to XLA.
A layer that holds a ``router`` (``ModelConfig.num_experts``, Mixtral-class)
has a top-k MoE MLP: every expert runs on every token, as in the JAX model.
A leaf may be an 8-bit :class:`~flashattention_tpu_torch.ops.quant.QuantizedWeight`
(``quantize_weights``): its payload is upcast to the activations' dtype for
the product and its per-column scales applied to the output, as the JAX
model does.  With an int8/fp8 KV cache the K/V rows are quantized per row
and head as they are written, and the scale pools ride beside the payload
pools into the paged kernels.  Each entry point accepts the JAX package's
``interpret`` keyword and ignores it (a CPU tensor runs the kernels' plain
versions).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from flashattention_tpu_torch.ops.decode import paged_attention, paged_prefill_attention_batched
from flashattention_tpu_torch.ops.dispatch import attention
from flashattention_tpu_torch.ops.quant import QUANT_DTYPES, QuantizedWeight, byte_view, quantize_rows
from flashattention_tpu_torch.utils.device import resolve_device
from flashattention_tpu_torch.utils.testing import to_torch

__all__ = [
    "ModelConfig",
    "init_params",
    "params_from_jax",
    "lora_from_jax",
    "prefill",
    "prefill_chunk",
    "prefill_chunk_batched",
    "decode_step",
    "decode_step_impl",
    "decode_loop",
    "verify_step",
    "speculative_accept",
]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 32000
    num_layers: int = 2
    d_model: int = 512
    num_q_heads: int = 8
    num_kv_heads: int = 4
    head_dim: int = 64
    intermediate: int = 1408
    rope_theta: float = 10000.0
    dtype: str = "bfloat16"
    sliding_window: int | None = None  # Mistral-style local attention
    logit_softcap: float | None = None  # Gemma-2-style score capping
    num_experts: int | None = None  # Mixtral-style MoE MLP (None = dense)
    experts_per_token: int = 2

    @property
    def group_size(self) -> int:
        if self.num_q_heads % self.num_kv_heads:
            raise ValueError("num_q_heads must be a multiple of num_kv_heads")
        return self.num_q_heads // self.num_kv_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @classmethod
    def tiny(cls) -> "ModelConfig":
        return cls(
            vocab_size=256, num_layers=2, d_model=128, num_q_heads=4,
            num_kv_heads=2, head_dim=32, intermediate=256,
        )

    @classmethod
    def llama7b_attention(cls) -> "ModelConfig":
        """Llama-7B attention geometry (H=32, d=128) in a 2-layer slice; the
        published depth is 32 layers (``dataclasses.replace`` it)."""
        return cls(
            vocab_size=32000, num_layers=2, d_model=4096,
            num_q_heads=32, num_kv_heads=32, head_dim=128, intermediate=11008,
        )

    @classmethod
    def mistral7b(cls, num_layers: int = 2) -> "ModelConfig":
        """Mistral-7B-class: GQA 32q/8kv, d=128, sliding window 4096."""
        return cls(
            vocab_size=32000, num_layers=num_layers, d_model=4096,
            num_q_heads=32, num_kv_heads=8, head_dim=128,
            intermediate=14336, sliding_window=4096,
        )

    @classmethod
    def gemma2_9b(cls, num_layers: int = 2) -> "ModelConfig":
        """Gemma-2-9B-class: GQA 16q/8kv, d=256, sliding window 4096 on every
        layer, attention-score softcap 50; the published depth is 42 layers.
        (As in the JAX preset: dense SwiGLU, untied embeddings, no post-norms
        or final-logit cap.)"""
        return cls(
            vocab_size=256128, num_layers=num_layers, d_model=3584,
            num_q_heads=16, num_kv_heads=8, head_dim=256,
            intermediate=14336, sliding_window=4096, logit_softcap=50.0,
        )

    @classmethod
    def mixtral8x7b(cls, num_layers: int = 2) -> "ModelConfig":
        """Mixtral-8x7B-class: Mistral geometry + 8-expert top-2 MoE MLP."""
        return cls(
            vocab_size=32000, num_layers=num_layers, d_model=4096,
            num_q_heads=32, num_kv_heads=8, head_dim=128,
            intermediate=14336, num_experts=8, experts_per_token=2,
        )


def init_params(seed: int, cfg: ModelConfig, *, device=None) -> dict:
    """Random parameters (scaled normal, fan-in), drawn on ``device`` (the
    card unless the caller asks for the CPU) from a generator seeded with
    ``seed``.  One matrix at a time is drawn in float32, then cast.  With
    ``cfg.num_experts`` each layer's MLP is a Mixtral-style MoE: a router
    ``(d, E)`` and expert stacks ``w_gate``/``w_up`` ``(E, d, f)`` and
    ``w_down`` ``(E, f, d)`` (the JAX ``init_params``' layout)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, hq, hkv, hd = cfg.d_model, cfg.num_q_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cfg.torch_dtype

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (w * fan_in**-0.5).to(dt)

    def ones(n):
        return torch.ones((n,), dtype=dt, device=dev)

    params = {
        "embed": dense((cfg.vocab_size, d), 1.0),
        "final_norm": ones(d),
        "lm_head": dense((d, cfg.vocab_size), d),
        "layers": [],
    }
    f = cfg.intermediate
    stack = () if cfg.num_experts is None else (cfg.num_experts,)
    for _ in range(cfg.num_layers):
        layer = {
            "attn_norm": ones(d),
            "wq": dense((d, hq * hd), d),
            "wk": dense((d, hkv * hd), d),
            "wv": dense((d, hkv * hd), d),
            "wo": dense((hq * hd, d), hq * hd),
            "mlp_norm": ones(d),
            "w_gate": dense((*stack, d, f), d),
            "w_up": dense((*stack, d, f), d),
            "w_down": dense((*stack, f, d), f),
        }
        if stack:
            layer["router"] = dense((d, cfg.num_experts), d)
        params["layers"].append(layer)
    return params


def params_from_jax(tree, *, device=None) -> dict:
    """The JAX package's parameter tree, given as numpy arrays, as the
    port's parameters on ``device``: same names, same ``x @ w`` layout, same
    dtypes (bfloat16 and fp8 included).  A quantized leaf (any object with
    ``payload``, ``scales`` and ``ldtype``, as the JAX package's
    ``QuantizedWeight`` has) becomes a :class:`QuantizedWeight`."""
    dev = resolve_device(device)

    def leaf(w):
        if hasattr(w, "payload") and hasattr(w, "scales"):
            return QuantizedWeight(to_torch(w.payload, dev), to_torch(w.scales, dev), str(w.ldtype))
        return to_torch(w, dev)

    return {
        "embed": leaf(tree["embed"]),
        "final_norm": leaf(tree["final_norm"]),
        "lm_head": leaf(tree["lm_head"]),
        "layers": [{name: leaf(w) for name, w in layer.items()} for layer in tree["layers"]],
    }


def lora_from_jax(lora, *, device=None) -> list:
    """The JAX package's LoRA tree (a list, one entry per layer, of
    ``{target: {"a", "b"}}``), given as numpy arrays, as the port's on
    ``device``: the same structure, names and dtypes."""
    dev = resolve_device(device)
    return [{t: {k: to_torch(ab[k], dev) for k in ("a", "b")} for t, ab in adapters.items()}
            for adapters in lora]


def _rmsnorm(x, w, eps=1e-6):
    xf = x.float()
    norm = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (norm * w.float()).to(x.dtype)


def _rope(x, positions, theta):
    """Rotate-half RoPE. x: (..., S, H, d); positions: (..., S)."""
    d = x.shape[-1]
    freqs = 1.0 / (
        theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    )
    angles = positions[..., None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2 :].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


def _mm(x, w):
    """x @ w; for a :class:`QuantizedWeight`, ``(x @ payload) * scales`` with
    the payload and scales cast to x's dtype, as the JAX model computes it
    (``x @ (p * s) == (x @ p) * s`` for per-column scales)."""
    if isinstance(w, QuantizedWeight):
        return (x @ w.payload.to(x.dtype)) * w.scales.to(x.dtype)
    return x @ w


def _lookup(emb, tokens):
    """Embedding rows; a quantized table's rows are scaled per column in
    float32 and cast to its logical dtype."""
    if isinstance(emb, QuantizedWeight):
        rows = byte_view(emb.payload)[tokens.long()].view(emb.payload.dtype)
        return (rows.float() * emb.scales).to(emb.dtype)
    return emb[tokens.long()]


def _es(x, w):
    """Every expert's product ``x @ w[e]`` over an expert stack ``w``
    ``(E, d_in, d_out)``: x ``(N, d_in)``, the same rows for every expert,
    or ``(E, N, d_in)``, each expert's own; returns ``(E, N, d_out)``.  The
    JAX ``_es`` (``einsum("...d,edf->...ef")`` and ``"...ef,efd->...ed"``)
    with the expert axis leading, so that no stack is copied; for a
    :class:`QuantizedWeight` the payload is cast to x's dtype and its
    ``(E, d_out)`` scales applied to the output."""
    if isinstance(w, QuantizedWeight):
        return torch.matmul(x, w.payload.to(x.dtype)) * w.scales.to(x.dtype)[:, None, :]
    return torch.matmul(x, w)


def _top_k(logits, k):
    """The k largest logits along the last axis and their indices, largest
    first and, among equal values, the lower index first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order for
    ties): a stable descending sort."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _mlp(x, layer, top_k: int = 2):
    """Dense SwiGLU or, for a layer with a router, the top-k MoE MLP.

    As in the JAX ``_mlp``, every expert runs on every token and the top-k
    outputs are combined by their softmaxed routing weights (float32, cast
    to x's dtype for the final sum): static shapes, no host sync.  Router
    logits are computed in x's dtype, as in JAX."""
    if "router" not in layer:
        gate = torch.nn.functional.silu(_mm(x, layer["w_gate"]))
        return _mm(gate * _mm(x, layer["w_up"]), layer["w_down"])
    lead, d = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, d)  # (N, d)
    logits = _mm(x2, layer["router"])  # (N, E)
    wk, idx = _top_k(logits, top_k)
    wk = torch.softmax(wk.float(), dim=-1)
    gate = torch.nn.functional.silu(_es(x2, layer["w_gate"]))  # (E, N, f)
    ye = _es(gate * _es(x2, layer["w_up"]), layer["w_down"])  # (E, N, d)
    # The routing weights of the chosen experts, 0 elsewhere (JAX's one-hot
    # sum: each token chooses k distinct experts).
    w_e = torch.zeros_like(logits, dtype=torch.float32).scatter(-1, idx, wk)  # (N, E)
    out = torch.einsum("ne,end->nd", w_e.to(x.dtype), ye)
    return out.reshape(*lead, d)


def _qkv(x, layer, cfg, positions):
    b, s, _ = x.shape
    q = _mm(x, layer["wq"]).reshape(b, s, cfg.num_q_heads, cfg.head_dim)
    k = _mm(x, layer["wk"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = _mm(x, layer["wv"]).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    return q, k, v


@torch.no_grad()
def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, interpret=None):
    """Full-sequence forward.

    tokens: (B, S) integer tensor on the parameters' device.  Returns
    (logits (B, S, V), k_rows, v_rows) with k_rows/v_rows (L, B, S, KVH, d)
    for the paged cache.
    """
    b, s = tokens.shape
    x = _lookup(params["embed"], tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    k_rows, v_rows = [], []
    for layer in params["layers"]:
        h = _rmsnorm(x, layer["attn_norm"])
        q, k, v = _qkv(h, layer, cfg, positions)
        k_rows.append(k)
        v_rows.append(v)
        # (B, S, H, d) -> (B, H, S, d).  The q projection orders heads
        # h = kvh * G + g, the grouping dispatch folds (native GQA: no K/V
        # head is repeated).
        o = attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, scale=cfg.head_dim**-0.5,
            window=cfg.sliding_window, logit_softcap=cfg.logit_softcap,
        )
        x = x + _mm(o.transpose(1, 2).reshape(b, s, -1), layer["wo"])
        x = x + _mlp(_rmsnorm(x, layer["mlp_norm"]), layer, cfg.experts_per_token)
    x = _rmsnorm(x, params["final_norm"])
    logits = _mm(x, params["lm_head"])
    return logits, torch.stack(k_rows), torch.stack(v_rows)


def _kept_rows(write_pages, write_slots, num_pages, device):
    """Flat indices, pages and slots of the rows whose write page lies in
    the pool (``0 <= page < num_pages``); the others are dropped, as the
    JAX scatters' ``mode="drop"`` drops them.  Found once per call: on host
    tensors (what the engine passes) with no device sync at all, on device
    tensors with one, never one per layer as boolean indexing would make."""
    wp, ws = write_pages.reshape(-1), write_slots.reshape(-1)
    rows = torch.nonzero((wp >= 0) & (wp < num_pages))[:, 0]
    return rows.to(device), wp[rows].long().to(device), ws[rows].long().to(device)


_QUANT_NAMES = {qdtype: name for name, (qdtype, _) in QUANT_DTYPES.items()}


def _write_rows(pages, scales, li, wp, ws, rows):
    """Scatter ``(n, KVH, d)`` rows into layer ``li``'s pool at pages ``wp``,
    slots ``ws``, in place; into an 8-bit pool quantized per row and head
    (the JAX model's ``_quantize_row``), with the scales into ``scales``."""
    if scales is not None:
        rows, sc = quantize_rows(rows, _QUANT_NAMES[pages.dtype])
        scales[li][wp, :, ws] = sc
    byte_view(pages[li])[wp, :, ws, :] = byte_view(rows.to(pages.dtype))


def _layer_scales(k_scales, v_scales, li):
    return {
        "k_scales_pages": None if k_scales is None else k_scales[li],
        "v_scales_pages": None if v_scales is None else v_scales[li],
    }


def decode_step_impl(
    params, tokens, positions, k_pages, v_pages, lengths, page_indices,
    write_pages, write_slots, cfg: ModelConfig, k_scales=None, v_scales=None,
    interpret=None, tp_group=None,
):
    """Decode-step body: see :func:`decode_step`.

    With ``tp_group`` (a ``torch.distributed`` group; ``cfg`` holding the
    rank's local head counts and ``params`` its Megatron column/row shards,
    ``train.common.shard_params``) the row-parallel products, after ``wo``
    and after the MLP, are all-reduced over the group in their dtype before
    each residual add, as the JAX body's ``psum`` over ``tp_axis``;
    otherwise the step is the single-device one.

    Each layer scatters this token's K/V row into its pool before its paged
    attention runs, so the token attends to itself (lengths include it).
    Where the JAX step donates the pools and returns new ones, this one
    updates ``k_pages``/``v_pages`` (and the scale pools) in place.  Rows
    whose write page is out of range (``>= P``, the inactive batch slots) are
    dropped before the scatter: the JAX step's ``mode="drop"``, which torch
    indexing lacks.
    """
    rows, wp, ws = _kept_rows(write_pages, write_slots, k_pages.shape[1], tokens.device)
    return _decode_body(params, tokens, positions, k_pages, v_pages, lengths, page_indices,
                        rows, wp, ws, cfg, k_scales, v_scales, tp_group)


def _all_reduce(x, group):
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _decode_body(params, tokens, positions, k_pages, v_pages, lengths, page_indices, rows, wp,
                 ws, cfg, k_scales, v_scales, tp_group=None):
    """One decode step with the kept rows ``rows`` written at pages ``wp``,
    slots ``ws`` (device tensors): no host sync but the all-reduces over
    ``tp_group``."""
    b = tokens.shape[0]
    x = _lookup(params["embed"], tokens)[:, None, :]  # (B, 1, d_model)
    pos = positions[:, None]
    for li, layer in enumerate(params["layers"]):
        h = _rmsnorm(x, layer["attn_norm"])
        q, k, v = _qkv(h, layer, cfg, pos)  # (B, 1, H, d)
        # In-place scatter into layer li's pool; (n, KVH, d) rows.
        _write_rows(k_pages, k_scales, li, wp, ws, k[rows, 0])
        _write_rows(v_pages, v_scales, li, wp, ws, v[rows, 0])
        qg = q[:, 0].reshape(b, cfg.num_kv_heads, cfg.group_size, cfg.head_dim)
        o = paged_attention(
            qg, k_pages[li], v_pages[li], lengths, page_indices,
            scale=cfg.head_dim**-0.5, window=cfg.sliding_window,
            logit_softcap=cfg.logit_softcap, **_layer_scales(k_scales, v_scales, li),
        )  # (B, KVH, G, d)
        x = x + _all_reduce(_mm(o.reshape(b, 1, cfg.num_q_heads * cfg.head_dim), layer["wo"]),
                            tp_group)
        x = x + _all_reduce(_mlp(_rmsnorm(x, layer["mlp_norm"]), layer, cfg.experts_per_token),
                            tp_group)
    x = _rmsnorm(x[:, 0], params["final_norm"])
    return _mm(x, params["lm_head"])


@torch.no_grad()
def decode_step(
    params,
    tokens: torch.Tensor,  # (B,) current tokens
    positions: torch.Tensor,  # (B,) positions (= old length) of those tokens
    k_pages: torch.Tensor,  # (L, P, KVH, ps, d) head-major, updated in place
    v_pages: torch.Tensor,  # updated in place
    lengths: torch.Tensor,  # (B,) int32 *including* the current token
    page_indices: torch.Tensor,  # (B, pages_per_seq) int32
    write_pages: torch.Tensor,  # (B,) physical page receiving this token's K/V
    write_slots: torch.Tensor,  # (B,) slot within that page
    cfg: ModelConfig,
    k_scales: torch.Tensor | None = None,  # (L, P, KVH, ps) for 8-bit pools, in place
    v_scales: torch.Tensor | None = None,
    interpret=None,
) -> torch.Tensor:
    """One decode token for a whole continuous batch over the paged cache.

    Inactive batch slots point ``write_pages`` at an out-of-range page (their
    rows are dropped) and have length 0.  Returns logits (B, V); the pools
    are updated in place (the JAX step donates them and returns new ones).
    """
    return decode_step_impl(
        params, tokens, positions, k_pages, v_pages, lengths, page_indices,
        write_pages, write_slots, cfg, k_scales, v_scales,
    )


@torch.no_grad()
def prefill_chunk_batched(
    params,
    tokens: torch.Tensor,  # (B, T) one chunk per request
    k_pages: torch.Tensor,  # (L, P, KVH, ps, d) head-major, updated in place
    v_pages: torch.Tensor,  # updated in place
    positions: torch.Tensor,  # (B, T) absolute positions of the tokens
    page_tables: torch.Tensor,  # (B, n_ctx_pages) int32 per-request tables
    write_pages: torch.Tensor,  # (B, T) page receiving each token's K/V
    write_slots: torch.Tensor,  # (B, T) slot within that page
    cfg: ModelConfig,
    k_scales: torch.Tensor | None = None,  # (L, P, KVH, ps) for 8-bit pools, in place
    v_scales: torch.Tensor | None = None,
    ctx_lens: torch.Tensor | None = None,  # (B,) int32 live context incl. this chunk
    interpret=None,
) -> torch.Tensor:
    """One chunk step of chunked prefill for many requests.

    Each layer scatters the chunk's K/V rows into its pool in place (the
    JAX function donates the pools and returns new ones), then attends the
    chunk's GQA-folded queries against the request's paged context with one
    :func:`~flashattention_tpu_torch.ops.decode.paged_prefill_attention_batched`
    launch.  Rows whose write page is out of range (``>= P``: the pad tail
    of a last chunk, and dummy batch rows) are dropped before the scatter;
    ``write_pages``/``write_slots`` may be host tensors, and then finding
    the kept rows costs no device sync.  Each GQA segment is the chunk
    itself (``seg = T``): the JAX function's pad of a segment to a multiple
    of 128 rows is a TPU tiling need.

    Dummy rows (batch padding) have ``ctx_lens[b] = 0`` and out-of-range
    write pages; their logits are garbage the engine never reads.  Returns
    logits ``(B, T, V)``.
    """
    if ctx_lens is None:
        raise ValueError("prefill_chunk_batched requires per-request ctx_lens")
    b, t = tokens.shape
    ps = k_pages.shape[3]
    if page_tables.shape[1] * ps < t:
        raise ValueError(
            f"page_tables cover {page_tables.shape[1] * ps} tokens < chunk size "
            f"{t}; they must span the full context including this chunk"
        )
    kvh, g, hd = cfg.num_kv_heads, cfg.group_size, cfg.head_dim
    x = _lookup(params["embed"], tokens)  # (B, T, d_model)
    rows, wp, ws = _kept_rows(write_pages, write_slots, k_pages.shape[1], x.device)
    for li, layer in enumerate(params["layers"]):
        h = _rmsnorm(x, layer["attn_norm"])
        q, k, v = _qkv(h, layer, cfg, positions)  # (B, T, H, d)
        _write_rows(k_pages, k_scales, li, wp, ws, k.reshape(b * t, kvh, hd)[rows])
        _write_rows(v_pages, v_scales, li, wp, ws, v.reshape(b * t, kvh, hd)[rows])
        # (B, T, H, d) -> (B, KVH, G * T, d): g-major segments of T rows.
        qf = q.transpose(1, 2).reshape(b, kvh, g * t, hd).contiguous()
        o = paged_prefill_attention_batched(
            qf, k_pages[li], v_pages[li], page_tables, ctx_lens,
            chunk=t, seg=t, scale=hd**-0.5, window=cfg.sliding_window,
            logit_softcap=cfg.logit_softcap, **_layer_scales(k_scales, v_scales, li),
        )  # (B, KVH, G * T, d)
        o = o.reshape(b, kvh * g, t, hd).transpose(1, 2).reshape(b, t, kvh * g * hd)
        x = x + _mm(o, layer["wo"])
        x = x + _mlp(_rmsnorm(x, layer["mlp_norm"]), layer, cfg.experts_per_token)
    # The JAX function's 2-D final stage: (B*T, dm) @ (dm, V) reduces each
    # row as the single-request (T, dm) @ (dm, V) does.
    x2 = _rmsnorm(x.reshape(b * t, -1), params["final_norm"])
    return _mm(x2, params["lm_head"]).reshape(b, t, -1)


@torch.no_grad()
def prefill_chunk(
    params,
    tokens: torch.Tensor,  # (T,) one request's next T prompt tokens
    k_pages: torch.Tensor,  # (L, P, KVH, ps, d), updated in place
    v_pages: torch.Tensor,
    positions: torch.Tensor,  # (T,) absolute positions
    page_indices: torch.Tensor,  # (n_ctx_pages,) int32 pages covering [0, ctx)
    write_pages: torch.Tensor,  # (T,)
    write_slots: torch.Tensor,  # (T,)
    cfg: ModelConfig,
    k_scales: torch.Tensor | None = None,  # (L, P, KVH, ps) for 8-bit pools, in place
    v_scales: torch.Tensor | None = None,
    ctx_len=None,  # live context tokens incl. this chunk (None: the whole table)
    interpret=None,
) -> torch.Tensor:
    """One chunk of a chunked prefill for one request: :func:`prefill_chunk_batched`
    with a batch of one.  Returns logits ``(T, V)``."""
    if ctx_len is None:
        ctx_len = page_indices.shape[0] * k_pages.shape[3]
    if torch.is_tensor(ctx_len):
        ctx = ctx_len.reshape(1).to(device=tokens.device, dtype=torch.int32)
    else:
        ctx = torch.tensor([int(ctx_len)], dtype=torch.int32, device=tokens.device)
    return prefill_chunk_batched(
        params, tokens[None], k_pages, v_pages, positions[None], page_indices[None],
        write_pages[None], write_slots[None], cfg, k_scales, v_scales, ctx_lens=ctx,
    )[0]


@torch.no_grad()
def decode_loop(
    params,
    tokens: torch.Tensor,  # (B,) current tokens
    positions: torch.Tensor,  # (B,) positions of those tokens
    k_pages: torch.Tensor,  # (L, P, KVH, ps, d) head-major, updated in place
    v_pages: torch.Tensor,  # updated in place
    page_indices: torch.Tensor,  # (B, pages_per_seq) int32 tables covering positions + n_steps
    cfg: ModelConfig,
    n_steps: int = 1,
    k_scales: torch.Tensor | None = None,  # (L, P, KVH, ps) for 8-bit pools, in place
    v_scales: torch.Tensor | None = None,
    active=None,  # (B,) bool on the host; None: every row
    generator: torch.Generator | None = None,
    temperature: float = 1.0,
    top_k: int | None = None,
    top_p: float | None = None,
    interpret=None,
) -> torch.Tensor:
    """``n_steps`` full decode steps in one call, each feeding the token it
    produced back in: the JAX package's ``decode_loop`` (its ``fori_loop``
    becomes a Python loop with no host sync in it).

    Step i writes each row's K/V at ``page_indices[b, pos // ps]``, slot
    ``pos % ps``, with ``pos = positions + i``, and attends ``pos + 1``
    tokens; the write pages are gathered on the device.  Rows that
    ``active`` marks False write nothing and attend nothing (length 0, as
    the engine's inactive batch slots); ``active`` is a host mask, so the
    kept rows are found once, before the loop.

    ``generator`` None: greedy (the first maximum).  Otherwise each step
    draws once from the filtered logits of the active rows with
    :func:`~flashattention_tpu_torch.ops.sampling.sample_logits`, as the
    engine's per-token step draws for them, so n steps of this loop give
    the tokens of n per-token steps under one generator.

    Returns the generated tokens ``(B, n_steps)`` int64, on the device; the
    pools are updated in place."""
    from flashattention_tpu_torch.ops.sampling import sample_logits

    b = tokens.shape[0]
    dev = tokens.device
    ps = k_pages.shape[3]
    mask = torch.ones(b, dtype=torch.bool) if active is None else torch.as_tensor(active).cpu()
    if mask.shape != (b,):
        raise ValueError(f"active {tuple(mask.shape)} does not match batch {b}")
    # From a host mask, copied without a host sync (the pageable copy is
    # staged before it returns).
    rows = torch.nonzero(mask)[:, 0].to(dev, non_blocking=True)
    live = mask.to(dev, non_blocking=True)
    toks, pos = tokens.long(), positions.long()
    out = torch.zeros((b, n_steps), dtype=torch.long, device=dev)
    for i in range(n_steps):
        wp = page_indices[rows, pos[rows] // ps].long()
        lengths = torch.where(live, pos + 1, 0).to(torch.int32)
        logits = _decode_body(params, toks, pos, k_pages, v_pages, lengths, page_indices, rows,
                              wp, pos[rows] % ps, cfg, k_scales, v_scales)
        if generator is None:
            toks = torch.argmax(logits, dim=-1)
        else:
            toks = torch.zeros(b, dtype=torch.long, device=dev)
            toks[rows] = sample_logits(generator, logits[rows], temperature=temperature,
                                       top_k=top_k, top_p=top_p)
        out[:, i] = toks
        pos = pos + 1
    return out


@torch.no_grad()
def verify_step(
    params,
    tokens: torch.Tensor,  # (B, k): the current token, then k - 1 drafts
    positions: torch.Tensor,  # (B,) position of tokens[:, 0]
    k_pages: torch.Tensor,  # (L, P, KVH, ps, d) head-major, updated in place
    v_pages: torch.Tensor,  # updated in place
    page_indices: torch.Tensor,  # (B, pages_per_seq) int32 covering positions + k
    write_pages: torch.Tensor,  # (B, k) page per fed token (out of range: dropped)
    write_slots: torch.Tensor,  # (B, k)
    cfg: ModelConfig,
    k_scales: torch.Tensor | None = None,  # (L, P, KVH, ps) for 8-bit pools, in place
    v_scales: torch.Tensor | None = None,
    interpret=None,
) -> torch.Tensor:
    """Speculative verification: score k fed tokens per request in one pass.

    Feeds ``tokens[:, j]`` at ``positions + j``, scatters all B * k K/V rows
    (8-bit pools quantized per row), and attends with the paged decode
    kernel's draft form (``paged_attention(draft_k=k)``: q folded to
    ``(B, KVH, G * k, d)`` k-minor, row j seeing the columns up to its own
    position), so verification reads the cache once, not k times.
    ``logits[:, j]`` is the next-token distribution after token j.
    Rejected drafts' rows stay in the pools: the caller trims the sequence
    back (the engine's ``cache.trim``).  ``write_pages``/``write_slots`` may
    be host tensors, and then no device sync is made.  Returns logits
    ``(B, k, V)``."""
    b, kk = tokens.shape
    kvh, g, hd = cfg.num_kv_heads, cfg.group_size, cfg.head_dim
    x = _lookup(params["embed"], tokens)  # (B, k, d_model)
    pos = positions[:, None].long() + torch.arange(kk, device=x.device)[None]
    lengths = (positions.long() + kk).to(torch.int32)  # every fed token included
    rows, wp, ws = _kept_rows(write_pages, write_slots, k_pages.shape[1], x.device)
    for li, layer in enumerate(params["layers"]):
        h = _rmsnorm(x, layer["attn_norm"])
        q, k, v = _qkv(h, layer, cfg, pos)  # (B, k, H, d)
        _write_rows(k_pages, k_scales, li, wp, ws, k.reshape(b * kk, kvh, hd)[rows])
        _write_rows(v_pages, v_scales, li, wp, ws, v.reshape(b * kk, kvh, hd)[rows])
        # (B, k, H, d) -> (B, KVH, G * k, d), k-minor within each query head.
        qg = q.reshape(b, kk, kvh, g, hd).permute(0, 2, 3, 1, 4).reshape(b, kvh, g * kk, hd)
        o = paged_attention(
            qg.contiguous(), k_pages[li], v_pages[li], lengths, page_indices,
            scale=hd**-0.5, draft_k=kk, window=cfg.sliding_window,
            logit_softcap=cfg.logit_softcap, **_layer_scales(k_scales, v_scales, li),
        )  # (B, KVH, G * k, d)
        o = o.reshape(b, kvh, g, kk, hd).permute(0, 3, 1, 2, 4).reshape(b, kk, kvh * g * hd)
        x = x + _mm(o, layer["wo"])
        x = x + _mlp(_rmsnorm(x, layer["mlp_norm"]), layer, cfg.experts_per_token)
    x = _rmsnorm(x, params["final_norm"])
    return _mm(x, params["lm_head"])


def speculative_accept(drafts: torch.Tensor, logits: torch.Tensor):
    """Greedy accept/reject for speculative decoding.

    drafts ``(B, k - 1)``: the drafts fed to :func:`verify_step` after the
    current token; logits ``(B, k, V)`` from it.  Draft j is accepted while
    it equals the argmax of ``logits[:, j - 1]`` (the first maximum, as
    ``jnp.argmax``); the first mismatch is replaced by the model's own
    token, and when all match the model's next token follows.  Returns
    ``(n_emitted (B,), emitted (B, k))``: each row appends
    ``emitted[:n_emitted]``, 1 <= n_emitted <= k."""
    km1 = drafts.shape[1]
    preds = torch.argmax(logits, dim=-1).to(drafts.dtype)  # (B, k)
    match = preds[:, :km1] == drafts
    n_accept = torch.cumprod(match.long(), dim=1).sum(dim=1)
    idx = torch.arange(km1 + 1, device=drafts.device)[None]
    corr = torch.gather(preds, 1, n_accept.clamp(max=km1)[:, None])
    emitted = torch.where(idx < n_accept[:, None], torch.nn.functional.pad(drafts, (0, 1)), corr)
    return n_accept + 1, emitted
