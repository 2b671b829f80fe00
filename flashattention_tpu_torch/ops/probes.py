"""H100 probes: the wrappers of the probe kernels, each beside the plain
PyTorch version of the function its mode computes.

The JAX package's ``scripts/probe_*.py`` are TPU loop-body timers: each
builds a Pallas kernel (``pl.pallas_call``) that does part of the forward's
work, to see what each part costs.  Their ports are modes of these sources:

- ``csrc/probe_mma.cu`` (library ``probe_mma``): ``fa_probe_mma`` runs
  ``flash_fwd_tc.cuh``'s kernel in its probe modes (:data:`MMA_MODES`; 0 is
  the kernel itself), ``fa_probe_int8`` the forward over 8-bit K/V in three
  flavors (:data:`INT8_FLAVORS`), ``fa_probe_stream`` a plain stream of an
  attention call's bytes and paged decode's page walk (:func:`probe_stream_sum`,
  :func:`probe_page_walk`);
- ``csrc/probe_d128.cu`` (libraries ``probe_d128_0`` and ``probe_d128_1``):
  the d = 128 forward built up stage by stage (:data:`D128_MODES`);
- ``csrc/probe_d128t.cu`` (``probe_d128t``) and ``probe_d128.cu``'s
  ``probe_d128_2``: the transposed schedule and the thin shapes of
  scripts/probe_d128d.py and probe_d128e.py, unscaled, float32 O
  (:data:`D128DE_MODES`, :func:`probe_d128de`);
- ``csrc/probe_fp32.cu`` (``probe_fp32``): float32 attention as two bf16
  terms, scripts/probe_small_fp32b.py (:data:`FP32_MODES`,
  :func:`probe_fp32`, inputs packed by :func:`fp32_inputs`).

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
    "D128DE_MODES",
    "D128_MODES",
    "FP32_MODES",
    "INT8_FLAVORS",
    "MMA_MODES",
    "fp32_inputs",
    "lo3_term_f32_qkv",
    "lo_term_f32_qkv",
    "lo_term_qkv",
    "lolo_term_f32_qkvdo",
    "probe_d128",
    "probe_d128_plain",
    "probe_d128de",
    "probe_d128de_plain",
    "probe_fp32",
    "probe_fp32_plain",
    "probe_int8",
    "probe_int8_plain",
    "probe_mma",
    "probe_mma_plain",
    "probe_page_walk",
    "probe_page_walk_plain",
    "probe_stream_sum",
    "probe_stream_sum_plain",
    "v3_term_f32_qkv",
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


def lo_term_f32_qkv(bh: int, s: int, d: int, *, generator=None, device="cpu"):
    """float32 ``q, k, v (BH, S, d)`` on which, at scale 1, the float32
    form's every cross product and second term moves the output: a form
    that drops one misses by far more than 1e-4 of the output's magnitude.
    Query row r is ``(1024 + u, 1024, 0, ...)`` with u in {1, 2, 3}, q_hi
    = (1024, 1024) and q_lo = (u, 0); key j is ``(h, 4 - h + e 2^-11, 0,
    ...)`` with h in (1, 2) on a 1/64 grid and e in {-2, ..., 2}, k_hi = (h,
    4 - h) and k_lo = (0, e 2^-11).  So q_hi k_hi = 4096 for every key, and
    the scores' differences come from q_lo k_hi = u h and q_hi k_lo = e / 2
    alone (q_lo k_lo = 0; every partial sum exact in float32).  V's rows
    are +/-(1 + n / 4), n normal, a random sign per key: where a row sees
    few keys of either sign (causal rows), its output is a difference of
    P's values, of which P's second terms, and V's, carry about 2^-9."""
    kw = dict(generator=generator, device=device)
    q = torch.zeros((bh, s, d), device=device)
    q[..., 0] = 1024 + torch.randint(1, 4, (bh, s), **kw).float()
    q[..., 1] = 1024
    h = 1 + torch.randint(1, 64, (bh, s), **kw) / 64
    k = torch.zeros((bh, s, d), device=device)
    k[..., 0] = h
    k[..., 1] = 4 - h + torch.randint(-2, 3, (bh, s), **kw) * 2.0**-11
    sign = torch.where(torch.rand((bh, s, 1), **kw) < 0.5, -1.0, 1.0)
    v = sign * (1 + torch.randn((bh, s, d), **kw) / 4)
    return q.contiguous(), k.contiguous(), v.contiguous()


def lolo_term_f32_qkvdo(bh: int, s: int, d: int, *, generator=None, device="cpu"):
    """float32 ``q, k, v, dO (BH, S, d)`` on which, at scale 1, the lo lo
    products of the backward's S and dP (``q_lo k_lo``, ``dO_lo v_lo``) move
    each score and each dP by a different multiple of its float32 step while
    every partial sum of the four products stays exact in float32: a
    backward that keeps them where it should not, or drops them (the JAX
    pair's lane-packed products at d = 64), misses by about 1e-3 of each
    gradient's norm.  Query row r is ``(1024 + u, 1024, 0, ...)`` with u in
    {1, 2, 3} (q_hi = (1024, 1024), q_lo = (u, 0)); key j is ``(h + e 2^-11,
    4 - h, 0, ...)`` with h in (1, 2) on a 1/64 grid and e in {-3, ..., 3}
    (k_hi = (h, 4 - h), k_lo = (e 2^-11, 0)).  So q_hi k_hi = 4096 for every
    key, q_hi k_lo = e / 2, q_lo k_hi = u h and q_lo k_lo = u e 2^-11, all
    multiples of 2^-11, the float32 step at 4096.  dO's rows are ``(1 + u'
    2^-10, 1, 0, ...)`` and V's keys are drawn as K's: dO_hi v_hi = 4 and
    dO_lo v_lo = u' e' 2^-21, the step at 4."""
    kw = dict(generator=generator, device=device)

    def keys():
        h = 1 + torch.randint(1, 64, (bh, s), **kw) / 64
        x = torch.zeros((bh, s, d), device=device)
        x[..., 0] = h + torch.randint(-3, 4, (bh, s), **kw) * 2.0**-11
        x[..., 1] = 4 - h
        return x

    q = torch.zeros((bh, s, d), device=device)
    q[..., 0] = 1024 + torch.randint(1, 4, (bh, s), **kw).float()
    q[..., 1] = 1024
    do = torch.zeros((bh, s, d), device=device)
    do[..., 0] = 1 + torch.randint(1, 4, (bh, s), **kw) * 2.0**-10
    do[..., 1] = 1
    k, v = keys(), keys()
    return q, k, v, do


def lo3_term_f32_qkv(bh: int, s: int, d: int, *, generator=None, device="cpu"):
    """float32 ``q, k, v (BH, S, d)`` on which, at scale 1, each third-term
    product of the ``"float32"`` mode (XLA's HIGHEST: x1 y3, x2 y2, x3 y1)
    moves the scores by 2^-9 to 2^-7 and the output by far more than 1e-4
    of its magnitude, so a form that drops one, or that keeps two terms a
    value, misses, while every partial sum of the six products stays exact
    in float32.  Query row r is ``(1024 + u + j 2^-8, 1024 + u', 0, ...)``
    with u, u' in {2, 3} and j = +/-1 (terms 1024, u, j 2^-8 and 1024, u');
    key j is ``(h, 4 - h + e 2^-11 + g 2^-19, 0, ...)`` with h in (1, 2) on a
    1/8 grid, e in {+/-2, +/-3} and g = +/-1 (terms h; 4 - h, e 2^-11, g
    2^-19).  So x1 y1 = 4096 for every key; x1 y2 = e / 2, x2 y1 = u h + u'
    (4 - h); x1 y3 = g 2^-9, x2 y2 = u' e 2^-11, x3 y1 = j h 2^-8, all
    multiples of 2^-11, the float32 step at 4096; the products HIGHEST
    drops (x2 y3 = u' g 2^-19) are 4e-6 and less.  V's rows are +/-(1 + n /
    4), n normal, a random sign per key, as in :func:`lo_term_f32_qkv`."""
    kw = dict(generator=generator, device=device)

    def pm(*shape):  # +/-1
        return torch.where(torch.rand(shape, **kw) < 0.5, -1.0, 1.0)

    q = torch.zeros((bh, s, d), device=device)
    q[..., 0] = 1024 + torch.randint(2, 4, (bh, s), **kw).float() + pm(bh, s) * 2.0**-8
    q[..., 1] = 1024 + torch.randint(2, 4, (bh, s), **kw).float()
    h = 1 + torch.randint(1, 8, (bh, s), **kw) / 8
    e = torch.randint(2, 4, (bh, s), **kw) * pm(bh, s)
    k = torch.zeros((bh, s, d), device=device)
    k[..., 0] = h
    k[..., 1] = 4 - h + e * 2.0**-11 + pm(bh, s) * 2.0**-19
    v = pm(bh, s, 1) * (1 + torch.randn((bh, s, d), **kw) / 4)
    return q.contiguous(), k.contiguous(), v.contiguous()


def v3_term_f32_qkv(bh: int, d: int, *, generator=None, device="cpu"):
    """float32 ``q, k, v (BH, d, d)`` on which, at scale 1 and causal, row r
    attends key r alone (q and k rows are 16 e_r: a score of 256 against 0,
    every other weight exactly 0), so its output is V's row r exactly, each
    value ``+/-64 (1 + 1.5 2^-9 + 1.5 b 2^-18)`` with b = +/-1, whose three
    bf16 terms are 64, 1.5 2^-3 and 1.5 b 2^-12 (signed): a form that drops
    V's third term misses by 3.7e-4, while the six products' sums stay
    exact in float32 (the output is V's row to the last bit)."""
    kw = dict(generator=generator, device=device)

    def pm(*shape):
        return torch.where(torch.rand(shape, **kw) < 0.5, -1.0, 1.0)

    eye = 16 * torch.eye(d, device=device).expand(bh, d, d)
    v = 64 * pm(bh, d, d) * (1 + 1.5 * 2.0**-9 + 1.5 * pm(bh, d, d) * 2.0**-18)
    return eye.contiguous(), eye.contiguous(), v.contiguous()


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


# ------------------------------------------- probe_d128de: items 4 and 5


@dataclasses.dataclass(frozen=True)
class D128DEMode:
    """One mode of scripts/probe_d128d.py or probe_d128e.py on the card:
    its entry's mode number, what it computes (see :func:`probe_d128de_plain`)
    and how it runs and stores."""

    mode: int
    item: str  # the TPU probe's variant
    var: str  # rescale | full | exp | qk_heavy | pv_heavy
    transposed: bool = True  # S^T = K Q^T and O^T = V^T P^T (csrc/probe_d128t.cu)
    vt: bool = True  # V stored (BH, d, S)
    o_t: bool = True  # O stored (BH, d, S)
    bf16_out: bool = False  # O rounded once to bf16 (stored as float32)

    @property
    def library(self) -> str:
        return "probe_d128t" if self.transposed else "probe_d128_2"


D128DE_MODES = {
    "base": D128DEMode(18, "probe_d128d.py base", "rescale", transposed=False, vt=False,
                       o_t=False),
    "t_vt": D128DEMode(0, "probe_d128d.py t_vt", "rescale"),
    "t_vtk": D128DEMode(1, "probe_d128d.py t_vtk", "rescale", vt=False),
    "t_full": D128DEMode(2, "probe_d128d.py t_full", "full"),
    "t_o_norm": D128DEMode(3, "probe_d128d.py t_o_norm", "rescale", o_t=False),
    "t_qk_heavy": D128DEMode(4, "probe_d128e.py t_qk_heavy", "qk_heavy"),
    "t_pv_heavy": D128DEMode(5, "probe_d128e.py t_pv_heavy", "pv_heavy"),
    "pv_bf16out": D128DEMode(19, "probe_d128e.py pv_bf16out", "exp", transposed=False, vt=False,
                             o_t=False, bf16_out=True),
}


def probe_d128de(name: str, q, k, v):
    """Mode ``name`` of :data:`D128DE_MODES`, unscaled and non-causal, over
    bf16 ``q, k (BH, S, 128)`` and ``v`` ``(BH, 128, S)`` where the mode
    stores it so (``vt``), else ``(BH, S, 128)``; S a multiple of 128.
    Returns float32 O, ``(BH, 128, S)`` where the mode stores it so
    (``o_t``), else ``(BH, S, 128)``."""
    cfg = D128DE_MODES[name]
    bh, s, d = q.shape
    v_shape = (bh, d, s) if cfg.vt else (bh, s, d)
    if d != 128 or s % KV_TILE or tuple(k.shape) != (bh, s, d) or tuple(v.shape) != v_shape:
        raise ValueError(f"probe_d128de {name}: q, k (BH, S, 128), v {v_shape}, S a multiple of "
                         f"{KV_TILE}; got q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if not _on_card("probe_d128de", q, k, v):
        return probe_d128de_plain(name, q, k, v)
    _bf16("probe_d128de", q, k, v)
    o = torch.empty((bh, d, s) if cfg.o_t else (bh, s, d), dtype=torch.float32, device=q.device)
    lib = kernels.library(cfg.library)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    if cfg.transposed:
        status = lib.fa_probe_d128t(cfg.mode, *ptrs, bh, s, _stream(q))
    else:
        status = lib.fa_probe_d128(cfg.mode, *ptrs, bh, s, s, 1.0, _stream(q))
    kernels.check_launch(cfg.library, status, f"mode {name}")
    _count(probe_d128de, name)
    return o


probe_d128de.launches = 0
probe_d128de.launches_by_mode = {}


def probe_d128de_plain(name: str, q, k, v):
    """The function of mode ``name``, 128-key tile by tile, unscaled (S = Q
    K^T), P (S itself in the heavy modes) entering PV as two bf16 terms:
    ``rescale`` O = sum exp(S - m) V, unnormalized, m the row's running max,
    O rescaled when it moves (scripts/probe_d128d.py's base and t_* modes:
    the transposed schedule's per-query max along the keys is the same
    max); ``full`` that divided by l, the sum of the float32 p;
    ``exp`` P = exp(S - 5), O = P V rounded once to bf16 (pv_bf16out);
    ``qk_heavy`` O = S[:, :128] V[:128]; ``pv_heavy`` O = sum over the V
    tiles of S_small V_tile, S_small = Q K[:128]^T.  Float32 O in the
    mode's layout."""
    cfg = D128DE_MODES[name]
    qf, kf = q.float(), k.float()
    vf = (v.transpose(1, 2) if cfg.vt else v).float()
    bh, rows, d = q.shape
    o = torch.zeros((bh, rows, d), device=q.device)
    if cfg.var == "qk_heavy":
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, :KV_TILE])
        o = torch.einsum("bqk,bkd->bqd", _two_term_bf16(s), vf[:, :KV_TILE])
    elif cfg.var == "pv_heavy":
        p = _two_term_bf16(torch.einsum("bqd,bkd->bqk", qf, kf[:, :KV_TILE]))
        for t0 in range(0, vf.shape[1], KV_TILE):
            o = o + torch.einsum("bqk,bkd->bqd", p, vf[:, t0:t0 + KV_TILE])
    else:
        m = torch.full((bh, rows), -torch.inf, device=q.device)
        l = torch.zeros((bh, rows), device=q.device)
        for t0 in range(0, kf.shape[1], KV_TILE):
            s = torch.einsum("bqd,bkd->bqk", qf, kf[:, t0:t0 + KV_TILE])
            if cfg.var == "exp":
                p, alpha = _exp(s - 5.0), torch.ones_like(m)
            else:
                mx = torch.maximum(m, s.amax(dim=-1))
                alpha, m = _exp(m - mx), mx
                p = _exp(s - mx[..., None])
            l = alpha * l + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum("bqk,bkd->bqd", _two_term_bf16(p),
                                                    vf[:, t0:t0 + KV_TILE])
        if cfg.var == "full":
            o = o / torch.where(l == 0, 1.0, l)[..., None]
    if cfg.bf16_out:
        o = o.to(torch.bfloat16).float()
    return o.transpose(1, 2).contiguous() if cfg.o_t else o


# ---------------------------------------------------------------- probe_fp32

# scripts/probe_small_fp32b.py's variants: their mode numbers in
# csrc/probe_fp32.cu.  All but bf16_skel take packed [hi | lo] operands.
FP32_MODES = {"skeleton": 0, "exp": 1, "full": 2, "bf16_skel": 3}


def _row_padded(x):
    """``x (BH, S, w)`` as a view of a zero-padded buffer whose rows are a
    multiple of 8 elements (16 bytes) apart, as TMA reads them."""
    w = x.shape[2]
    buf = torch.zeros((*x.shape[:2], -(-w // 8) * 8), dtype=x.dtype, device=x.device)
    buf[..., :w] = x
    return buf[..., :w]


def _pack2(x):
    """scripts/probe_small_fp32b.py's ``pack2`` (:39): ``[hi | lo]`` with
    hi = bf16(x), lo = bf16(x - hi)."""
    hi = x.to(torch.bfloat16)
    return torch.cat([hi, (x - hi.float()).to(torch.bfloat16)], dim=-1)


def fp32_inputs(q, k, v, mode: str):
    """The operands of mode ``mode`` from float32 ``q, k, v (BH, S, d)``, as
    the script's main builds them: packed ``q, k (BH, S, 2d)`` and ``v (BH,
    S, 2d + 1)`` = ``[v_hi | v_lo | 1]``; for ``bf16_skel`` q, k in bf16 and
    ``v = [v | 1]``.  v is a view whose rows lie a multiple of 16 bytes
    apart (:func:`_row_padded`)."""
    ones = torch.ones((*v.shape[:2], 1), dtype=torch.bfloat16, device=v.device)
    if mode == "bf16_skel":
        return (q.to(torch.bfloat16), k.to(torch.bfloat16),
                _row_padded(torch.cat([v.to(torch.bfloat16), ones], dim=-1)))
    return _pack2(q), _pack2(k), _row_padded(torch.cat([_pack2(v), ones], dim=-1))


def probe_fp32(mode: str, q, k, v):
    """``fa_probe_fp32`` (scripts/probe_small_fp32b.py), mode ``mode`` of
    :data:`FP32_MODES`, unscaled and non-causal, over :func:`fp32_inputs`'
    operands: q, k ``(BH, S, 2d)`` bf16 ``[hi | lo]`` and v ``(BH, S, 2d +
    1)`` ``[v_hi | v_lo | 1]`` (bf16_skel: ``(BH, S, d)`` and ``(BH, S, d +
    1)``), d = 64, v's rows a multiple of 8 elements apart; S a multiple of
    128.  Returns acc float32 ``(BH, S, 64)`` (the TPU probe's output holds
    it twice, ``[acc | acc]``, only for its timer's chaining)."""
    packed = mode != "bf16_skel"
    bh, s, w = q.shape
    vw = w + 1
    if (mode not in FP32_MODES or w != (128 if packed else 64) or s % KV_TILE
            or tuple(k.shape) != (bh, s, w) or tuple(v.shape) != (bh, s, vw)):
        raise ValueError(f"probe_fp32 {mode}: q, k (BH, S, {128 if packed else 64}), v (BH, S, "
                         f"{(128 if packed else 64) + 1}), S a multiple of {KV_TILE}; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not _on_card("probe_fp32", q, k, v):
        return probe_fp32_plain(mode, q, k, v)
    _bf16("probe_fp32", q, k)
    row = v.stride(1)
    if (v.dtype != torch.bfloat16 or v.stride(2) != 1 or row % 8 or v.stride(0) != s * row):
        raise ValueError(f"probe_fp32 takes v in bf16 with rows a multiple of 8 elements apart, "
                         f"got {v.dtype} strides {v.stride()}")
    kernels.check_aligned("probe_fp32", q, k, v)
    o = torch.empty((bh, s, 64), dtype=torch.float32, device=q.device)
    status = kernels.library("probe_fp32").fa_probe_fp32(
        FP32_MODES[mode], q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, row,
        _stream(q))
    kernels.check_launch("probe_fp32", status, f"mode {mode}")
    _count(probe_fp32, mode)
    return o


probe_fp32.launches = 0
probe_fp32.launches_by_mode = {}


def probe_fp32_plain(mode: str, q, k, v):
    """The function of mode ``mode`` in the kernel's tile order (128 keys):
    S = q . k + q . k_swap over the packed rows (bf16_skel: q . k), P = S,
    exp(S - 5) or, for ``full``, exp(S - m) against the running max with
    every column rescaled when it moves; P as two bf16 terms against v
    (bf16_skel: one), ones column included; acc = out[:, :d] + out[:, d:2d]
    (bf16_skel: out[:, :d]), ``full`` divided by l = out[:, 2d]."""
    packed = mode != "bf16_skel"
    d = q.shape[2] // 2 if packed else q.shape[2]
    qf, kf, vf = q.float(), k.float(), v.float()
    bh, rows, _ = q.shape
    m = torch.full((bh, rows), -torch.inf, device=q.device)
    out = torch.zeros((bh, rows, vf.shape[2]), device=q.device)
    for t0 in range(0, kf.shape[1], KV_TILE):
        kt, vt = kf[:, t0:t0 + KV_TILE], vf[:, t0:t0 + KV_TILE]
        s = torch.einsum("bqd,bkd->bqk", qf, kt)
        if packed:
            s = s + torch.einsum("bqd,bkd->bqk", qf, torch.cat([kt[..., d:], kt[..., :d]], dim=-1))
        alpha = torch.ones_like(m)
        if mode == "exp":
            s = _exp(s - 5.0)
        elif mode == "full":
            mx = torch.maximum(m, s.amax(dim=-1))
            alpha, m = _exp(m - mx), mx
            s = _exp(s - mx[..., None])
        p = _two_term_bf16(s) if packed else s.to(torch.bfloat16).float()
        out = out * alpha[..., None] + torch.einsum("bqk,bkd->bqd", p, vt)
    acc = out[..., :d] + out[..., d:2 * d] if packed else out[..., :d]
    if mode == "full":
        l = out[..., 2 * d]
        acc = acc / torch.where(l == 0, 1.0, l)[..., None]
    return acc
