"""H100 probes: the wrappers of the probe kernels, each beside the plain
PyTorch version of the function its mode computes.

The JAX package's ``scripts/probe_*.py`` are TPU loop-body timers: each
builds a Pallas kernel (``pl.pallas_call``) that does part of the forward's
work, to see what each part costs.  Their ports are modes of two sources:

- ``csrc/probe_mma.cu`` (library ``probe_mma``): ``fa_probe_mma`` runs
  ``flash_fwd_tc.cuh``'s kernel in its probe modes (:data:`MMA_MODES`; 0 is
  the kernel itself), ``fa_probe_int8`` the forward over 8-bit K/V in three
  flavors (:data:`INT8_FLAVORS`), ``fa_probe_stream`` a plain stream of an
  attention call's bytes and paged decode's page walk (:func:`probe_stream_sum`,
  :func:`probe_page_walk`);
- ``csrc/probe_d128.cu`` (libraries ``probe_d128_0`` and ``probe_d128_1``):
  the d = 128 forward built up stage by stage (:data:`D128_MODES`).

On a CUDA tensor each wrapper launches its kernel or raises, and adds one to
its ``launches`` count (and to ``launches_by_mode``); on a CPU tensor it runs
the plain version.  The plain versions mirror each kernel's own rounding and
order: P (or S) entering PV as two bf16 terms where the kernel splits it
(:func:`ops.flash._two_term_bf16`), the online softmax's running max and
rescale per KV tile of 128 keys, chains dealt tiles round-robin, the tiles a
consumer warpgroup of 64 rows skips past its diagonal, and ``int8mma``'s
8-bit q and p with the tile's largest V scale.  ``torch_tools/probe_*.py``
and ``chip_smoke.py``'s ``probes`` phase go through these wrappers.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from flashattention_tpu_torch.ops import kernels
from flashattention_tpu_torch.ops.flash import _exp, _two_term_bf16
from flashattention_tpu_torch.ops.reference import DEFAULT_MASK_VALUE

__all__ = [
    "D128_MODES",
    "INT8_FLAVORS",
    "MMA_MODES",
    "lo_term_qkv",
    "probe_d128",
    "probe_d128_plain",
    "probe_int8",
    "probe_int8_plain",
    "probe_mma",
    "probe_mma_plain",
    "probe_page_walk",
    "probe_page_walk_plain",
    "probe_stream_sum",
    "probe_stream_sum_plain",
]

KV_TILE = 128  # KV rows a tile: every probe kernel's, at d = 64 and 128
WG_ROWS = 64  # query rows a consumer warpgroup owns

# fa_probe_mma's modes: (what, head_dims built, TPU kernel it ports).
MMA_MODES = {
    0: ("the whole forward (flash_fwd_tc's kernel)", (64, 128), "the kernel itself"),
    1: ("QK^T products and the softmax, no PV products", (64, 128),
        "scripts/probe_mxu.py::_qk_like :38"),
    2: ("PV products on a constant P = 1/128, no QK^T, no softmax", (64, 128),
        "scripts/probe_mxu.py::_pv_like :100"),
    3: ("local softmax: each tile against its own max, rescaled", (64,),
        "scripts/probe_local_softmax.py::build :41"),
    4: ("2 independent (m, l, O) chains, merged at the end", (64, 128),
        "scripts/probe_chain.py::build :40; at d = 128 scripts/probe_d128.py split2 :73"),
    5: ("4 independent (m, l, O) chains, merged at the end", (64,),
        "scripts/probe_chain.py::build :40"),
}
INT8_FLAVORS = ("bf16", "int8cvt", "int8mma")


@dataclasses.dataclass(frozen=True)
class D128Mode:
    """One mode of ``csrc/probe_d128.cu``: its entry's mode number and the
    compile-time form it runs (see the source for what each asks)."""

    mode: int
    item: str  # the TPU probe it ports, scripts/probe_d128[bcf].py
    var: str = "skeleton"  # skeleton | exp | maxexp | full
    terms: int = 2  # bf16 terms of P (S) into PV
    rows: int = 128  # query rows a block (64 per consumer warpgroup)
    tiles: int = 1  # (head, query-block) tiles a block
    split: int = 1  # PV accumulators a 64-column part
    kt: bool = False  # K stored (BH, d, S)
    vt: bool = False  # V stored (BH, d, S)

    @property
    def library(self) -> str:
        return f"probe_d128_{0 if self.mode < 9 else 1}"


D128_MODES = {
    "skeleton": D128Mode(0, "probe_d128.py:74-81 skeleton"),
    "exp": D128Mode(1, "probe_d128.py:74-81 exp", var="exp"),
    "maxexp": D128Mode(2, "probe_d128.py:74-81 maxexp", var="maxexp"),
    "pcast": D128Mode(3, "probe_d128b.py pcast", terms=1),
    "bq64": D128Mode(4, "probe_d128b.py bq256", rows=64),
    "bq192": D128Mode(5, "probe_d128b.py bq1024", rows=192),
    "bh2": D128Mode(6, "probe_d128b.py bh2", tiles=2),
    "pcast_bq192": D128Mode(7, "probe_d128b.py pcast_bq1024", terms=1, rows=192),
    "pcast_bh2": D128Mode(8, "probe_d128b.py pcast_bh2", terms=1, tiles=2),
    "pv_split2": D128Mode(9, "probe_d128c.py pv_split2", split=2),
    "pv_split4": D128Mode(10, "probe_d128c.py pv_split4", split=4),
    "vt": D128Mode(11, "probe_d128c.py vt", vt=True),
    "vt_split2": D128Mode(12, "probe_d128c.py vt_split2", split=2, vt=True),
    "qk_nn": D128Mode(13, "probe_d128c.py qk_nn", kt=True),
    "full_bq128_split2": D128Mode(14, "probe_d128f.py bq512 split2", var="full", split=2),
    "full_bq192_split1": D128Mode(15, "probe_d128f.py bq1024 split1", var="full", rows=192),
    "full_bq192_split2": D128Mode(16, "probe_d128f.py bq1024 split2", var="full", rows=192,
                                  split=2),
    "full_bq128_split1": D128Mode(17, "probe_d128f.py bq512 split1", var="full"),
}

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ENTRIES = {  # the probe_mma library's other entry points
    "fa_probe_int8": [_I, *[_P] * 6, *[_I] * 6, _F, _P],
    "fa_probe_stream": [_I, *[_P] * 6, _L, *[_I] * 8, _P],
}


def _entry(name: str):
    fn = getattr(kernels.library("probe_mma"), name)
    if fn.argtypes is None:
        fn.argtypes = _ENTRIES[name]
        fn.restype = ctypes.c_int
    return fn


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_card(name: str, *tensors) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA tensors
    on one device; raises otherwise."""
    devs = {t.device for t in tensors if t is not None}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors on {sorted(map(str, devs))}")
    return True


def _count(fn, key) -> None:
    fn.launches += 1
    fn.launches_by_mode[key] = fn.launches_by_mode.get(key, 0) + 1


def _bf16(name: str, *tensors) -> None:
    bad = [t.dtype for t in tensors if t.dtype != torch.bfloat16 or not t.is_contiguous()]
    if bad:
        raise ValueError(f"{name} takes contiguous bfloat16 tensors, got {bad}")


def lo_term_qkv(bh: int, s: int, d: int, *, generator=None, device="cpu"):
    """bf16 ``q, k, v (BH, S, d)`` whose output at scale 1 is carried by
    P's second bf16 term alone.  Every query row is ``(1, 1, 0, ...)``; keys
    come in pairs ``(h, e, 0, ...)`` and ``(h, -e, 0, ...)`` with h in
    (1, 2) on bf16's grid and e in {1, 2, 3} x 2^-10, under half of h's
    bf16 step, so S = h +/- e is exact in float32, bf16(S) = h and
    S - bf16(S) = +/-e exactly; their V rows are ``v`` and ``-v``, v's
    entries in {+/-1/2, +/-1, +/-2}.  The first terms cancel pair by pair:
    where S itself enters PV, O = sum 2 e v with two terms (every partial
    sum exact in float32) and 0 with one; through a softmax, O holds the
    pairs' differences of P (about 2 e P), which two terms carry and one
    rounds to 0 or a whole bf16 step.  S a multiple of 2."""
    kw = dict(generator=generator, device=device)
    n = s // 2
    h = 1 + torch.randint(1, 128, (bh, n), **kw) / 128
    e = torch.randint(1, 4, (bh, n), **kw) * 2.0**-10
    q = torch.zeros((bh, s, d), device=device)
    q[..., :2] = 1
    k = torch.zeros((bh, n, 2, d), device=device)
    k[:, :, :, 0] = h[..., None]
    k[:, :, 0, 1], k[:, :, 1, 1] = e, -e
    mag = 2.0 ** torch.randint(-1, 2, (bh, n, d), **kw)
    vj = torch.where(torch.rand((bh, n, d), **kw) < 0.5, -mag, mag)
    v = torch.stack([vj, -vj], dim=2)
    return tuple(x.reshape(bh, s, d).to(torch.bfloat16).contiguous() for x in (q, k, v))


# ---------------------------------------------------------------- probe_mma


def probe_mma(mode: int, q, k, v, *, causal: bool = False, scale: float | None = None):
    """``fa_probe_mma``: ``flash_fwd_tc.cuh``'s kernel in probe mode ``mode``
    (:data:`MMA_MODES`) over bf16 ``q (BH, R, d)``, ``k, v (BH, S, d)``, no
    window or softcap.  Returns ``(o, l, m)`` as the kernel writes them."""
    bh, rows, d = q.shape
    if mode not in MMA_MODES or d not in MMA_MODES[mode][1]:
        raise ValueError(f"probe_mma: no mode {mode} at head_dim {d}")
    scale = d**-0.5 if scale is None else float(scale)
    if not _on_card("probe_mma", q, k, v):
        return probe_mma_plain(mode, q, k, v, causal=causal, scale=scale)
    _bf16("probe_mma", q, k, v)
    o = torch.empty_like(q)
    l = torch.empty((bh, rows), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    status = kernels.library("probe_mma").fa_probe_mma(
        mode, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), l.data_ptr(), m.data_ptr(),
        bh, rows, k.shape[1], d, int(bool(causal)), scale, _stream(q))
    kernels.check_launch("probe_mma", status, f"mode {mode} at head_dim {d}")
    _count(probe_mma, mode)
    return o, l, m


probe_mma.launches = 0
probe_mma.launches_by_mode = {}


def _tile_live(rows, s_kv, causal, device):
    """``live[i, r]``: whether the consumer warpgroup of row r takes KV tile
    i (causal: none past its last row's diagonal), and the tile count."""
    n = -(-s_kv // KV_TILE)
    r = torch.arange(rows, device=device)
    if not causal:
        return torch.ones((n, rows), dtype=torch.bool, device=device), n
    pmax = torch.clamp((r // WG_ROWS + 1) * WG_ROWS, max=rows) - 1
    t0 = torch.arange(n, device=device)[:, None] * KV_TILE
    return t0 <= pmax[None, :], n


def probe_mma_plain(mode: int, q, k, v, *, causal: bool = False, scale: float = 1.0):
    """The function of ``fa_probe_mma``'s mode ``mode``, in the kernel's
    tile order: 0 the forward (the online softmax over 128-key tiles, P into
    PV as two bf16 terms against the running max), 1 its ``(l, m)`` with O
    all zeros, 2 O = the sum of the live tiles' V rows over 128 (P = 1/128,
    exact in bf16; l = 0, m = -inf), 3 the local softmax, 4 and 5 the tiles
    dealt round-robin to 2 and 4 chains merged at the end.  A tile past a
    warpgroup's diagonal is skipped for its rows, as the kernel skips it."""
    bh, rows, d = q.shape
    s_kv = k.shape[1]
    live, n = _tile_live(rows, s_kv, causal, q.device)
    qf, kf, vf = q.float(), k.float(), v.float()
    if mode == 2:
        o = torch.zeros((bh, rows, d), device=q.device)
        for i in range(n):
            part = vf[:, i * KV_TILE:(i + 1) * KV_TILE].sum(dim=1) / KV_TILE
            o += torch.where(live[i][None, :, None], part[:, None, :], 0.0)
        l = torch.zeros((bh, rows), device=q.device)
        return o.to(q.dtype), l, torch.full_like(l, -torch.inf)
    chains = {4: 2, 5: 4}.get(mode, 1)
    local = mode == 3
    pos = torch.arange(rows, device=q.device)
    m = [torch.full((bh, rows), -torch.inf, device=q.device) for _ in range(chains)]
    l = [torch.zeros((bh, rows), device=q.device) for _ in range(chains)]
    acc = [torch.zeros((bh, rows, d), device=q.device) for _ in range(chains)]
    for i in range(n):
        c = i % chains
        t0 = i * KV_TILE
        kt, vt = kf[:, t0:t0 + KV_TILE], vf[:, t0:t0 + KV_TILE]
        s = torch.einsum("bqd,bkd->bqk", qf, kt) * scale
        if causal:
            cols = torch.arange(t0, t0 + kt.shape[1], device=q.device)
            s = torch.where(cols[None, None, :] <= pos[None, :, None], s, DEFAULT_MASK_VALUE)
        mx = s.amax(dim=-1)
        if local:
            mn = torch.maximum(m[c], mx)
            alpha, beta = _exp(m[c] - mn), _exp(mx - mn)
            p = _exp(s - mx[..., None])
        else:
            mn = torch.maximum(m[c], mx)
            alpha, beta = _exp(m[c] - mn), torch.ones_like(mn)
            p = _exp(s - mn[..., None])
        new_l = alpha * l[c] + beta * p.sum(dim=-1)
        if mode == 1:
            new_acc = acc[c]
        else:
            part = torch.einsum("bqk,bkd->bqd", _two_term_bf16(p), vt)
            new_acc = acc[c] * alpha[..., None] + part * beta[..., None]
        rl = live[i][None, :]
        m[c] = torch.where(rl, mn, m[c])
        l[c] = torch.where(rl, new_l, l[c])
        acc[c] = torch.where(rl[..., None], new_acc, acc[c])
    mm = m[0]
    for c in range(1, chains):
        mm = torch.maximum(mm, m[c])
    lt, o = torch.zeros_like(l[0]), torch.zeros_like(acc[0])
    for c in range(chains):
        f = torch.ones_like(mm) if chains == 1 else torch.where(
            mm == -torch.inf, 1.0, _exp(m[c] - mm))
        lt = lt + f * l[c]
        o = o + f[..., None] * acc[c]
    o = o / torch.where(lt == 0, 1.0, lt)[..., None]
    if mode == 1:
        o = torch.zeros_like(o)
    return o.to(q.dtype), lt, mm


# --------------------------------------------------------------- probe_int8


def probe_int8(flavor: str, q, k, v, k_scales=None, v_scales=None, *, kv_len=None, q_offset=0,
               causal: bool = False, scale: float = 1.0):
    """``fa_probe_int8`` (scripts/probe_int8_decode.py's three flavors) at
    head_dim 128, no window, softcap or GQA fold: ``bf16`` the forward over
    bf16 K/V, ``int8cvt`` over int8 K/V converted to bf16 in shared memory
    (``flash_fwd_tc_quant``'s kernel), ``int8mma`` native s8 products.
    q, o ``(BH, R, 128)`` bf16; k, v ``(BH, S, 128)`` bf16 or int8 with
    float32 scales ``(BH, S)``."""
    if flavor not in INT8_FLAVORS:
        raise ValueError(f"probe_int8: no flavor {flavor!r}")
    bh, rows, d = q.shape
    s_kv = k.shape[1]
    kv_len = s_kv if kv_len is None else int(kv_len)
    if d != 128:
        raise ValueError(f"probe_int8 runs at head_dim 128, got {d}")
    kw = dict(kv_len=kv_len, q_offset=q_offset, causal=causal, scale=scale)
    if not _on_card("probe_int8", q, k, v, k_scales, v_scales):
        return probe_int8_plain(flavor, q, k, v, k_scales, v_scales, **kw)
    if flavor != "bf16":
        if k.dtype != torch.int8 or v.dtype != torch.int8 or k_scales is None:
            raise ValueError("probe_int8: the 8-bit flavors take int8 K/V and their scales")
        kernels.check_aligned("probe_int8", k, v)
    sc = (k_scales, v_scales) if flavor != "bf16" else (None, None)
    o = torch.empty_like(q)
    status = _entry("fa_probe_int8")(
        INT8_FLAVORS.index(flavor), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        *(None if t is None else t.data_ptr() for t in sc), o.data_ptr(), bh, rows, s_kv,
        kv_len, int(q_offset), int(bool(causal)), float(scale), _stream(q))
    kernels.check_launch("probe_mma", status, f"fa_probe_int8 {flavor}")
    _count(probe_int8, flavor)
    return o


probe_int8.launches = 0
probe_int8.launches_by_mode = {}


def probe_int8_plain(flavor, q, k, v, k_scales=None, v_scales=None, *, kv_len=None, q_offset=0,
                     causal=False, scale=1.0):
    """The function of each flavor: ``bf16`` and ``int8cvt`` are the
    tensor-core forward's (``flash_attention_plain(form="tc")``, the 8-bit
    form with its scales); ``int8mma`` mirrors the native products: q
    quantized per row (absmax / 127, round to nearest even, clamped to
    ±127), the integer scores times q's and k's scales and the scale, the
    online softmax over 128-key tiles, p quantized as rint(127 p), its
    integer product with the int8 V scaled back by the tile's largest
    v_scale / 127 (the TPU probe's coarse per-page V scale), l the sum of
    the float32 p."""
    from flashattention_tpu_torch.ops.flash import flash_attention_plain

    s_kv = k.shape[1]
    kv_len = s_kv if kv_len is None else kv_len
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, kv_len=kv_len, form="tc")
    if flavor == "bf16":
        return flash_attention_plain(q, k, v, **kw)
    if flavor == "int8cvt":
        return flash_attention_plain(q, k, v, k_scales=k_scales, v_scales=v_scales, **kw)
    bh, rows, d = q.shape
    qf = q.float()
    amax = qf.abs().amax(dim=-1)
    qs = torch.where(amax == 0, 1.0, amax / 127.0)
    q8 = torch.clamp(torch.round(qf / qs[..., None]), -127, 127)
    pos = q_offset + torch.arange(rows, device=q.device)
    m = torch.full((bh, rows), -torch.inf, device=q.device)
    l = torch.zeros((bh, rows), device=q.device)
    acc = torch.zeros((bh, rows, d), device=q.device)
    end = min(kv_len, q_offset + rows) if causal else kv_len
    for t0 in range(0, end, KV_TILE):
        cols = torch.arange(t0, t0 + KV_TILE, device=q.device)
        inside = cols < kv_len
        kt = torch.zeros((bh, KV_TILE, d), device=q.device)
        vt = torch.zeros_like(kt)
        w = min(KV_TILE, s_kv - t0)
        kt[:, :w], vt[:, :w] = k[:, t0:t0 + w].float(), v[:, t0:t0 + w].float()
        kt, vt = kt * inside[None, :, None], vt * inside[None, :, None]
        ks = torch.zeros((bh, KV_TILE), device=q.device)
        vs = torch.zeros_like(ks)
        ks[:, :w], vs[:, :w] = k_scales[:, t0:t0 + w], v_scales[:, t0:t0 + w]
        ks, vs = ks * inside, vs * inside
        si = torch.einsum("bqd,bkd->bqk", q8, kt)  # exact: |si| < 2^24
        x = si * qs[..., None] * ks[:, None, :] * scale
        keep = inside[None, None, :]
        if causal:
            keep = keep & (cols[None, None, :] <= pos[None, :, None])
        x = torch.where(keep, x, DEFAULT_MASK_VALUE)
        mx = torch.maximum(m, x.amax(dim=-1))
        alpha = _exp(m - mx)
        m = mx
        p = _exp(x - mx[..., None])
        l = alpha * l + p.sum(dim=-1)
        p8 = torch.round(p * 127.0)
        pv = torch.einsum("bqk,bkd->bqd", p8, vt)  # exact: < 2^24
        back = vs.amax(dim=-1) * (1.0 / 127.0)
        acc = acc * alpha[..., None] + pv * back[:, None, None]
    return (acc / torch.where(l == 0, 1.0, l)[..., None]).to(q.dtype)


# ------------------------------------------------------------- probe_stream


def probe_stream_sum(a, b, c):
    """``fa_probe_stream`` mode 0 (scripts/probe_small_fp32.py's
    ``hbm_floor``): ``a + b + c`` over float32 tensors of one shape, a
    multiple of 4 elements."""
    if not _on_card("probe_stream", a, b, c):
        return probe_stream_sum_plain(a, b, c)
    if any(t.dtype != torch.float32 or not t.is_contiguous() or t.shape != a.shape
           for t in (a, b, c)) or a.numel() % 4:
        raise ValueError("probe_stream_sum takes contiguous float32 tensors of one shape, "
                         "a multiple of 4 elements")
    kernels.check_aligned("probe_stream_sum", a, b, c)
    o = torch.empty_like(a)
    status = _entry("fa_probe_stream")(0, a.data_ptr(), b.data_ptr(), c.data_ptr(), o.data_ptr(),
                                       None, None, a.numel(), 0, 0, 0, 0, 0, 0, 0, 0, _stream(a))
    kernels.check_launch("probe_mma", status, "fa_probe_stream hbm_floor")
    _count(probe_stream_sum, "hbm_floor")
    return o


probe_stream_sum.launches = 0
probe_stream_sum.launches_by_mode = {}


def probe_stream_sum_plain(a, b, c):
    """``a + b + c`` in float32, as the kernel adds them (left to right)."""
    return a + b + c


def _walk_range(length, split, tiles_per_split, page_size, pages_per_seq, window):
    end = min(length, pages_per_seq * page_size)
    first = max(0, length - window) if window else 0
    c0 = max(split * tiles_per_split * 64, first)
    c1 = min((split + 1) * tiles_per_split * 64, end)
    return c0, c1


def probe_page_walk(k_pages, v_pages, lengths, table, *, splits: int, tiles_per_split: int,
                    window: int | None = None):
    """``fa_probe_stream`` mode 1: paged decode's reads alone.  For each
    (request, KV head, split) block, the XOR of every 32-bit word of K ^ V
    over the rows ``paged_decode_tc``'s block reads (the split's 64-row
    tiles in [first, end), first the window's first column), as an int32
    ``(B, KVH, splits)``.  Pools ``(P, KVH, page_size, d)`` of any element
    type with rows a multiple of 16 bytes; lengths ``(B,)``, table
    ``(B, pages_per_seq)`` int32."""
    nb, pps = table.shape
    _, kvh, ps, d = k_pages.shape
    row_bytes = d * k_pages.element_size()
    if not _on_card("probe_page_walk", k_pages, v_pages, lengths, table):
        return probe_page_walk_plain(k_pages, v_pages, lengths, table, splits=splits,
                                     tiles_per_split=tiles_per_split, window=window)
    if row_bytes % 16:
        raise ValueError(f"probe_page_walk takes rows of a multiple of 16 bytes, got {row_bytes}")
    kernels.check_aligned("probe_page_walk", k_pages, v_pages)
    words = torch.zeros((nb, kvh, splits), dtype=torch.int32, device=k_pages.device)
    status = _entry("fa_probe_stream")(
        1, k_pages.data_ptr(), v_pages.data_ptr(), None, words.data_ptr(), lengths.data_ptr(),
        table.data_ptr(), 0, nb, kvh, row_bytes, ps, pps, splits, tiles_per_split, window or 0,
        _stream(k_pages))
    kernels.check_launch("probe_mma", status, "fa_probe_stream page_walk")
    _count(probe_page_walk, "page_walk")
    return words


probe_page_walk.launches = 0
probe_page_walk.launches_by_mode = {}


def _xor_fold(x: torch.Tensor) -> torch.Tensor:
    """XOR of every element along the last axis (int32)."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.nn.functional.pad(x, (0, 1))
        h = x.shape[-1] // 2
        x = x[..., :h] ^ x[..., h:]
    return x[..., 0]


def probe_page_walk_plain(k_pages, v_pages, lengths, table, *, splits, tiles_per_split,
                          window=None):
    """The page walk's folded words, gathered through the table row by row."""
    nb, pps = table.shape
    _, kvh, ps, _ = k_pages.shape
    kw = k_pages.contiguous().view(torch.uint8).view(torch.int32)
    vw = v_pages.contiguous().view(torch.uint8).view(torch.int32)
    words = torch.zeros((nb, kvh, splits), dtype=torch.int32, device=k_pages.device)
    lens, tab = lengths.tolist(), table.tolist()
    for b in range(nb):
        for sp in range(splits):
            c0, c1 = _walk_range(lens[b], sp, tiles_per_split, ps, pps, window)
            if c1 <= c0:
                continue
            cols = torch.arange(c0, c1)
            pages = torch.tensor(tab[b], dtype=torch.long)[cols // ps].to(k_pages.device)
            slot = (cols % ps).to(k_pages.device)
            x = kw[pages, :, slot] ^ vw[pages, :, slot]  # (cols, kvh, units)
            words[b, :, sp] = _xor_fold(x.transpose(0, 1).reshape(kvh, -1))
    return words


# --------------------------------------------------------------- probe_d128


def probe_d128(name: str, q, k, v, *, scale: float | None = None):
    """``fa_probe_d128`` (``csrc/probe_d128.cu``), mode ``name`` of
    :data:`D128_MODES` over bf16 ``q (BH, R, 128)`` and ``k, v (BH, S, 128)``
    (``(BH, 128, S)`` where the mode stores them transposed: ``kt``, ``vt``),
    S a multiple of 128, non-causal, no mask.  Returns o ``(BH, R, 128)``
    bf16 (the full softmax's normalized, the other stages' sums as they
    stand)."""
    cfg = D128_MODES[name]
    bh, rows, d = q.shape
    s_kv = k.shape[2] if cfg.kt else k.shape[1]
    if d != 128 or s_kv % KV_TILE or bh % cfg.tiles:
        raise ValueError(f"probe_d128 {name}: head_dim 128, S a multiple of {KV_TILE} and BH "
                         f"a multiple of {cfg.tiles}; got q {tuple(q.shape)}, k {tuple(k.shape)}")
    scale = d**-0.5 if scale is None else float(scale)
    if not _on_card("probe_d128", q, k, v):
        return probe_d128_plain(name, q, k, v, scale=scale)
    _bf16("probe_d128", q, k, v)
    o = torch.empty_like(q)
    status = kernels.library(cfg.library).fa_probe_d128(
        cfg.mode, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, rows, s_kv, scale,
        _stream(q))
    kernels.check_launch(cfg.library, status, f"mode {name}")
    _count(probe_d128, name)
    return o


probe_d128.launches = 0
probe_d128.launches_by_mode = {}


def probe_d128_plain(name: str, q, k, v, *, scale: float = 1.0):
    """The function of mode ``name``, tile by 128-key tile: S = scale Q K^T;
    ``skeleton`` P = S, ``exp`` P = exp(S - 5), ``maxexp`` P = exp(S - m)
    with m the running row max (no rescale, no sums), ``full`` the online
    softmax (normalized at the end); P (one bf16 term where ``terms`` is 1,
    else two) times the tile's V, summed into O in float32.  Block rows,
    tiles a block, PV splits and the stored layouts change the schedule,
    not the function."""
    cfg = D128_MODES[name]
    kf = (k.transpose(1, 2) if cfg.kt else k).float()
    vf = (v.transpose(1, 2) if cfg.vt else v).float()
    qf = q.float()
    bh, rows, d = q.shape
    m = torch.full((bh, rows), -torch.inf, device=q.device)
    l = torch.zeros((bh, rows), device=q.device)
    o = torch.zeros((bh, rows, d), device=q.device)
    for t0 in range(0, kf.shape[1], KV_TILE):
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, t0:t0 + KV_TILE]) * scale
        if cfg.var == "skeleton":
            p = s
        elif cfg.var == "exp":
            p = _exp(s - 5.0)
        else:
            mx = torch.maximum(m, s.amax(dim=-1))
            alpha = _exp(m - mx)
            m = mx
            p = _exp(s - mx[..., None])
        pp = _two_term_bf16(p) if cfg.terms == 2 else p.to(torch.bfloat16).float()
        part = torch.einsum("bqk,bkd->bqd", pp, vf[:, t0:t0 + KV_TILE])
        if cfg.var == "full":
            l = alpha * l + p.sum(dim=-1)
            o = o * alpha[..., None] + part
        else:
            o = o + part
    if cfg.var == "full":
        o = o / torch.where(l == 0, 1.0, l)[..., None]
    return o.to(q.dtype)
