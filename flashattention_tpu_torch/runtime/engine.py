"""Continuous-batching inference engine.

Counterpart of ``flashattention_tpu/runtime/engine.py``: requests arrive at
any time; the engine admits them FCFS when batch slots and KV pages allow
(the C++ runtime core's scheduler, ``runtime/native.py``), prefills their prompts, then advances all running requests one token per
:meth:`Engine.step` on the paged decode kernel.  Finished requests free their
pages at once, so waiting requests admit on the next step.  Under page
pressure the latest-admitted request is preempted and later re-prefilled
from its tokens (recompute preemption).

Prefill, with the default ``EngineConfig(prefill_chunk=512)``: a request
whose prompt starts with resident full pages of an earlier prompt adopts
them at admission (prefix caching, refcounted); prompts longer than the
chunk, and every prompt with an adopted prefix, run in lockstep chunk rounds
on the paged-prefill kernel (one batched call per round); the rest run whole
on the causal flash kernel, grouped by power-of-two length bucket.
``prefill_chunk=0`` runs every prompt whole and caches no prefixes.

With an int8/fp8 cache (``CacheConfig(dtype="int8" | "fp8")``) the chunk and
decode steps quantize the K/V rows they write and attend on the kernels'
8-bit forms; whole-prompt prefill attends to the unquantized K/V and the
cache quantizes them as it appends them, as in the JAX engine.  Parameters
from ``ops.quant.quantize_weights`` serve unchanged.  The constructor takes
the JAX engine's ``interpret`` keyword and ignores it.

Multi-token steps: ``run(multi_step=n)`` decodes n tokens for the whole
batch in one call (``transformer.decode_loop``) whenever no request waits,
every request has n tokens of budget and engine-default sampling, and n
slots per request can be reserved; otherwise it steps per token.
Speculative decoding: ``run_speculative(draft_fn, k)`` verifies each
request's current token and k - 1 drafts in one call
(``transformer.verify_step``, on the paged decode kernel's draft form),
emits the accepted drafts and one token of the model's, and trims the
rejected rows from the cache.

Checkpoint and resume: :meth:`Engine.state_dict` snapshots the requests'
tokens and the sampling generator's state as JSON, and
:meth:`Engine.from_state` rebuilds an engine that re-queues and re-prefills
every unfinished request (``utils/checkpoint.py`` writes both beside the
parameters).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from flashattention_tpu_torch.models import transformer
from flashattention_tpu_torch.ops import sampling
from flashattention_tpu_torch.runtime.kvcache import CacheConfig, PagedKVCache
from flashattention_tpu_torch.runtime.kvcache import _bucket as kv_bucket
from flashattention_tpu_torch.runtime.native import Scheduler
from flashattention_tpu_torch.utils.device import resolve_device

__all__ = ["EngineConfig", "SamplingParams", "Request", "Engine"]


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    pages_per_seq: int = 16  # max pages (=> max length) per request
    prefill_chunk: int = 512  # chunked prefill above this length (a multiple
    #   of page_size); 0 = whole-prompt prefill, no prefix caching
    greedy: bool = True  # False: temperature sampling from Engine.sample_gen
    temperature: float = 1.0
    top_k: int | None = None
    top_p: float | None = None
    eos_token: int | None = None

    def __post_init__(self):
        if not self.greedy and not self.temperature > 0.0:
            raise ValueError(
                f"temperature must be > 0 for sampling (got {self.temperature})"
            )
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1 (got {self.top_k})")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1] (got {self.top_p})")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling / stop configuration (None on a request means
    the engine defaults).  ``seed`` gives the request its own random stream,
    seeded per emitted-token position, so its continuation does not depend
    on what shares the batch."""

    greedy: bool = True
    temperature: float = 1.0
    top_k: int | None = None
    top_p: float | None = None
    seed: int | None = None
    eos_token: int | None = None
    stop_tokens: tuple = ()
    stop_sequences: tuple = ()  # tuple of token tuples
    logprobs: bool = False

    def __post_init__(self):
        if not self.greedy and not self.temperature > 0.0:
            raise ValueError(
                f"temperature must be > 0 for sampling (got {self.temperature})"
            )
        if self.top_k is not None and self.top_k < 1:
            raise ValueError(f"top_k must be >= 1 (got {self.top_k})")
        if self.top_p is not None and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1] (got {self.top_p})")
        for s in self.stop_sequences:
            if not len(s):
                raise ValueError("stop_sequences entries must be non-empty")

    @property
    def filter_key(self):
        """Rows with equal filter_key can share one batched sampling call."""
        return (self.greedy, self.temperature, self.top_k, self.top_p)


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: list
    max_new_tokens: int
    output: list = dataclasses.field(default_factory=list)
    state: str = "waiting"  # waiting | running | finished | cancelled
    sampling: SamplingParams | None = None
    logprobs: list = dataclasses.field(default_factory=list)
    on_token: object = None  # callable(req, token) or None

    @property
    def length(self) -> int:
        return len(self.prompt) + len(self.output)


def _bucket(n: int) -> int:
    return kv_bucket(n, lo=8)


class Engine:
    def __init__(
        self,
        params,
        model_cfg: transformer.ModelConfig,
        cache_cfg: CacheConfig,
        engine_cfg: EngineConfig = EngineConfig(),
        *,
        interpret: bool | None = None,
        device=None,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        if engine_cfg.prefill_chunk and engine_cfg.prefill_chunk % cache_cfg.page_size:
            raise ValueError(
                f"prefill_chunk ({engine_cfg.prefill_chunk}) must be a "
                f"multiple of page_size ({cache_cfg.page_size})"
            )
        self.params = params
        self.model_cfg = model_cfg
        self.cache = PagedKVCache(cache_cfg, device=self.device)
        self.cfg = engine_cfg
        self.scheduler = Scheduler(engine_cfg.max_batch, cache_cfg.page_size)
        self.requests: dict[int, Request] = {}
        self.running: list[int] = []  # req ids in batch-slot order
        self._next_id = 0
        self._last_admitted = 0
        # Draws for non-greedy engine-default sampling (jax.random's
        # Engine.sample_key in the JAX package).
        self.sample_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.on_token = None  # engine-wide streaming hook f(request, token)
        self._default_sampling = SamplingParams(
            greedy=engine_cfg.greedy,
            temperature=engine_cfg.temperature,
            top_k=engine_cfg.top_k,
            top_p=engine_cfg.top_p,
            eos_token=engine_cfg.eos_token,
        )
        # Serving counters (see stats()).
        self._n_steps = 0
        self._n_decode_tokens = 0
        self._n_prefill_tokens = 0
        self._n_preemptions = 0
        self._n_prefill_batches = 0
        self._n_chunk_rounds = 0
        self._n_decode_batches = 0
        self._n_spec_steps = 0
        self._n_spec_accepted = 0
        self._prefill_s = 0.0
        self._decode_s = 0.0
        self._spec_s = 0.0

    # ── public API ────────────────────────────────────────────────────────

    def add_request(self, prompt, max_new_tokens: int, *, sampling=None, on_token=None) -> int:
        """Queue a request.  ``sampling``: per-request :class:`SamplingParams`
        (None = engine defaults); ``on_token``: streaming callback
        ``f(request, token)`` called as each token is emitted."""
        # Fail fast on requests that could never complete.
        span = len(prompt) + max_new_tokens
        ps = self.cache.config.page_size
        need = -(-span // ps)
        cap = min(self.cfg.pages_per_seq, self.cache.config.num_pages)
        if need > cap:
            raise ValueError(
                f"request needs {need} pages ({span} tokens @ page_size {ps}) "
                f"but the engine caps at {cap} "
                f"(pages_per_seq={self.cfg.pages_per_seq}, "
                f"num_pages={self.cache.config.num_pages})"
            )
        req_id = self._next_id
        self._next_id += 1
        self.requests[req_id] = Request(
            req_id, list(prompt), max_new_tokens, sampling=sampling, on_token=on_token,
        )
        self.scheduler.add_request(req_id, len(prompt), max_new_tokens)
        return req_id

    def has_work(self) -> bool:
        return bool(self.running) or self.scheduler.num_waiting() > 0

    def cancel(self, req_id: int) -> bool:
        """Abort a request wherever it sits; its pages free at once and the
        tokens generated so far stay in its output.  False for unknown,
        finished or already-cancelled ids."""
        req = self.requests.get(req_id)
        if req is None or req.state in ("finished", "cancelled"):
            return False
        self.scheduler.cancel(req_id)
        if req_id in self.running:
            self.running.remove(req_id)
        if self.cache.has(req_id):
            self.cache.free_sequence(req_id)
        req.state = "cancelled"
        return True

    def run(self, max_steps: int = 10_000, multi_step: int = 1) -> dict[int, list]:
        """Drive steps until all requests finish; returns outputs by id.
        ``multi_step > 1``: up to that many tokens per step in one call
        (see :meth:`step`); the tokens are those of ``multi_step=1``."""
        return self._drive(lambda: self.step(multi_step=multi_step), max_steps)

    def run_speculative(self, draft_fn, k: int = 4, max_steps: int = 10_000) -> dict[int, list]:
        """Drive :meth:`step_speculative` until all requests finish."""
        return self._drive(lambda: self.step_speculative(draft_fn, k), max_steps)

    def _drive(self, step, max_steps: int) -> dict[int, list]:
        for _ in range(max_steps):
            if not self.has_work():
                break
            was_empty = not self.running
            step()
            if was_empty and self._last_admitted == 0 and self.scheduler.num_waiting() > 0:
                # A step that began with an empty batch admitted nothing: the
                # waiting requests can never fit.
                raise RuntimeError(
                    f"{self.scheduler.num_waiting()} waiting request(s) "
                    "cannot be admitted (insufficient free pages even with "
                    "an empty batch)"
                )
        return {rid: r.output for rid, r in self.requests.items()}

    # ── checkpoint / resume ───────────────────────────────────────────────

    def state_dict(self) -> dict:
        """Snapshot of the serving state, JSON-serializable (the JAX
        ``Engine.state_dict``).

        Recompute-style: each request's prompt, generated output, budget,
        state, sampling parameters and logprobs; the K/V pages derive from
        the tokens, so on restore unfinished requests re-queue and re-prefill
        their context, the path preemption takes.  In place of the JAX
        engine's ``sample_key``, ``sample_gen`` holds the state of the
        engine's ``torch.Generator`` as a list of ints, so that sampled
        serving resumes on the draws an uninterrupted engine would make.
        Seeded requests re-derive their stream from (seed, position)
        (:meth:`_seeded`), so nothing of theirs is stored.  ``on_token``
        callbacks do not survive a restore."""
        return {
            "next_id": self._next_id,
            "sample_gen": self.sample_gen.get_state().tolist(),
            "requests": [
                {
                    "req_id": r.req_id,
                    "prompt": list(r.prompt),
                    "max_new_tokens": r.max_new_tokens,
                    "output": list(r.output),
                    "state": r.state,
                    "sampling": dataclasses.asdict(r.sampling) if r.sampling is not None else None,
                    "logprobs": list(r.logprobs),
                }
                for r in self.requests.values()
            ],
        }

    @classmethod
    def from_state(cls, state: dict, params, model_cfg, cache_cfg, engine_cfg=None,
                   **kw) -> "Engine":
        """An engine rebuilt from :meth:`state_dict` (fresh pools):
        unfinished requests re-queue, their whole context (prompt and
        output so far) re-prefilled on admission.  ``kw`` go to the
        constructor (``interpret``, ``device``, ``seed``)."""
        eng = cls(params, model_cfg, cache_cfg, engine_cfg or EngineConfig(), **kw)
        eng._next_id = state["next_id"]
        if "sample_gen" in state:
            eng.sample_gen.set_state(torch.tensor(state["sample_gen"], dtype=torch.uint8))
        for r in state["requests"]:
            sp = r.get("sampling")
            if sp is not None:
                sp = SamplingParams(**{
                    **sp,
                    # JSON turns tuples into lists: back to tuples.
                    "stop_tokens": tuple(sp.get("stop_tokens", ())),
                    "stop_sequences": tuple(tuple(s) for s in sp.get("stop_sequences", ())),
                })
            req = Request(
                r["req_id"], list(r["prompt"]), r["max_new_tokens"], output=list(r["output"]),
                state=r["state"], sampling=sp, logprobs=list(r.get("logprobs", ())),
            )
            eng.requests[req.req_id] = req
            if req.state in ("finished", "cancelled"):
                continue
            req.state = "waiting"  # waiting or running: re-queued, re-prefilled
            eng.scheduler.add_request(req.req_id, req.length, req.max_new_tokens - len(req.output))
        return eng

    def step(self, multi_step: int = 1) -> None:
        """Admit + prefill new requests, then decode one token for all, or
        with ``multi_step = n > 1`` n tokens in one call when no request
        waits (:meth:`_decode_batch_many`)."""
        self._n_steps += 1
        self._admit_and_prefill()
        if not self.running:
            return
        if multi_step > 1 and self.scheduler.num_waiting() == 0 and self._decode_batch_many(multi_step):
            return
        self._decode_batch()

    def stats(self) -> dict:
        """Serving counters: steps, tokens in/out, preemptions, occupancy,
        the whole-prompt prefill batches, chunked-prefill rounds and decode
        batches (a multi-step call counts its n steps), and the host seconds
        (ending in a device sync) spent in prefill and decode.  Speculative
        steps add ``spec_steps`` (verify calls), ``spec_accepted`` (drafts
        accepted, within the requests' budgets) and ``spec_s``; their
        tokens count in ``decode_tokens``."""
        return {
            "steps": self._n_steps,
            "prefill_tokens": self._n_prefill_tokens,
            "decode_tokens": self._n_decode_tokens,
            "preemptions": self._n_preemptions,
            "running": len(self.running),
            "waiting": self.scheduler.num_waiting(),
            "free_pages": self.cache.num_free_pages(),
            "prefill_batches": self._n_prefill_batches,
            "chunk_rounds": self._n_chunk_rounds,
            "decode_batches": self._n_decode_batches,
            "prefill_s": self._prefill_s,
            "decode_s": self._decode_s,
            "spec_steps": self._n_spec_steps,
            "spec_accepted": self._n_spec_accepted,
            "spec_s": self._spec_s,
        }

    # ── engine step ───────────────────────────────────────────────────────

    def _admit_and_prefill(self) -> None:
        admitted = self.scheduler.admit(self.cache.num_free_pages())
        self._last_admitted = len(admitted)
        chunk = self.cfg.prefill_chunk
        short: dict[int, list[Request]] = {}  # bucketed length -> requests
        longs: list[Request] = []
        for req_id in admitted:
            req = self.requests[req_id]
            req.state = "running"
            self.running.append(req_id)
            shared = 0
            if chunk:
                # Adopt a resident shared prefix now (refcounted): adopting
                # later could race a preemption that frees the matched pages.
                n_sh, pages_sh = self.cache.match_prefix(req.prompt + req.output)
                if n_sh:
                    self.cache.adopt_prefix(req_id, pages_sh, n_sh)
                    shared = n_sh
            if chunk and (req.length > chunk or shared):
                longs.append(req)
            else:
                short.setdefault(_bucket(req.length), []).append(req)
        # Whole prompts first: a chunked prefill may preempt under page
        # pressure, and only requests whose KV state exists may be evicted.
        for sb, group in sorted(short.items()):
            self._prefill_batch(group, sb)
        if longs:
            self._prefill_chunked_many([r for r in longs if r.req_id in self.running])

    def _prefill_batch(self, reqs: list, sb: int) -> None:
        """Prefill a group of requests together, padded to the (sb) bucket.

        Pad tokens sit at each row's tail: valid rows never attend them under
        the causal mask and their K/V rows are never cached.  The batch pads
        to a power of two from 1, as in the JAX engine."""
        t0 = time.perf_counter()
        n = len(reqs)
        nb = kv_bucket(n)
        toks = np.zeros((nb, sb), np.int64)
        lens = []
        for i, req in enumerate(reqs):
            p = req.prompt + req.output
            toks[i, : len(p)] = p
            lens.append(len(p))
        logits, k_rows, v_rows = transformer.prefill(
            self.params, torch.from_numpy(toks).to(self.device), self.model_cfg
        )
        self._n_prefill_tokens += sum(lens)
        self._n_prefill_batches += 1
        # Cache rows of each real prompt only: (L, NB, Sb, KVH, d) -> (L, S_i, KVH, d).
        for i, req in enumerate(reqs):
            self.cache.append(req.req_id, k_rows[:, i, : lens[i]], v_rows[:, i, : lens[i]])
            if self.cfg.prefill_chunk:  # prefix caching rides the chunked path
                self.cache.register_prefix(req.req_id, req.prompt + req.output)
        last = logits[torch.arange(n, device=self.device), torch.tensor(lens, device=self.device) - 1]
        firsts = self._sample_rows(reqs, last)
        self._prefill_s += time.perf_counter() - t0
        for req, (tok, lp) in zip(reqs, zip(*firsts)):
            self._emit(req, tok, lp)

    def _reserve_or_preempt(self, rid: int) -> tuple[int, int]:
        while True:
            try:
                return self.cache.reserve_slot(rid)
            except MemoryError:
                if not self._preempt(exclude=rid):
                    raise

    def _prefill_chunked_many(self, reqs: list) -> None:
        """Chunked prefill of one or many prompts, in lockstep chunk rounds.

        Each round makes ONE :func:`transformer.prefill_chunk_batched` call
        for every request still prefilling, its batch padded to a power of
        two with ``ctx = 0`` dummy rows and its tables to a shared
        power-of-two page count (the JAX engine's buckets).  A request with
        an adopted prefix computes only the rest of its prompt.  The last
        chunk is padded to the chunk size: pad tokens reserve no slots and
        their K/V rows are dropped, but ``ctx`` counts them, since the kernel
        anchors the chunk's rows at ``ctx - chunk``; real rows never reach
        the pad columns.  A request preempted mid-way (a peer's reservation
        ran the pool dry) drops out and restarts on re-admission.  Each
        finished request is trimmed to its real length, publishes its full
        prompt pages, and samples its first token from the row of its last
        real token, ``(rem - 1) % chunk``."""
        t0 = time.perf_counter()
        c = self.cache.config
        chunk = self.cfg.prefill_chunk
        states = []
        for req in reqs:
            rid = req.req_id
            if rid not in self.running:
                continue
            prompt = req.prompt + req.output
            if self.cache.has(rid):
                skip = self.cache.length(rid)  # prefix adopted at admission
            else:
                skip, pages = self.cache.match_prefix(prompt)
                if skip:
                    self.cache.adopt_prefix(rid, pages, skip)
            rem = len(prompt) - skip
            padded = -(-rem // chunk) * chunk
            toks = np.zeros(padded, np.int64)
            toks[:rem] = prompt[skip:]
            states.append({
                "req": req, "rid": rid, "prompt": prompt, "s": len(prompt),
                "skip": skip, "rem": rem, "padded": padded, "toks": toks,
                "start": 0, "logits": None,
            })
        while True:
            live = [st for st in states if st["start"] < st["padded"] and st["rid"] in self.running]
            if not live:
                break
            # Reserve this round's slots for every live request first: a
            # reservation may preempt a peer, so membership is re-checked.
            reserved = {}
            for st in live:
                if st["rid"] not in self.running:
                    continue  # preempted by an earlier peer's reservation
                base = st["skip"] + st["start"]
                pages, slots = [], []
                for t in range(chunk):
                    if base + t < st["s"]:
                        pg, sl = self._reserve_or_preempt(st["rid"])
                    else:
                        pg, sl = c.num_pages, 0  # pad token: dropped write
                    pages.append(pg)
                    slots.append(sl)
                reserved[st["rid"]] = (pages, slots)
            live = [st for st in live if st["rid"] in self.running]
            if not live:
                continue
            cap = max(kv_bucket((st["skip"] + st["start"] + chunk) // c.page_size) for st in live)
            nb = kv_bucket(len(live))
            tokens = np.zeros((nb, chunk), np.int64)
            positions = np.zeros((nb, chunk), np.int64)
            tables = np.zeros((nb, cap), np.int32)
            wpages = np.full((nb, chunk), c.num_pages, np.int64)
            wslots = np.zeros((nb, chunk), np.int64)
            ctxs = np.zeros((nb,), np.int32)  # dummy rows: ctx = 0
            for i, st in enumerate(live):
                base = st["skip"] + st["start"]
                ctx = base + chunk
                tokens[i] = st["toks"][st["start"] : st["start"] + chunk]
                positions[i] = np.arange(base, ctx)
                have = self.cache.pages(st["rid"])[: ctx // c.page_size]
                tables[i, : len(have)] = have
                wpages[i], wslots[i] = reserved[st["rid"]]
                ctxs[i] = ctx
            dev = self.device
            logits = transformer.prefill_chunk_batched(
                self.params, torch.from_numpy(tokens).to(dev),
                self.cache.k_pages, self.cache.v_pages,
                torch.from_numpy(positions).to(dev), torch.from_numpy(tables).to(dev),
                torch.from_numpy(wpages), torch.from_numpy(wslots),  # host: no sync
                self.model_cfg, self.cache.k_scales, self.cache.v_scales,
                ctx_lens=torch.from_numpy(ctxs).to(dev),
            )  # the pools are updated in place
            self._n_chunk_rounds += 1
            for i, st in enumerate(live):
                st["start"] += chunk
                if st["start"] >= st["padded"]:
                    st["logits"] = logits[i, (st["rem"] - 1) % chunk]
        for st in states:  # in the JAX engine's order, request by request
            if st["logits"] is None or st["rid"] not in self.running:
                continue  # preempted: restarts cleanly on re-admission
            self.cache.trim(st["rid"], st["s"])
            self.cache.register_prefix(st["rid"], st["prompt"])
            self._n_prefill_tokens += st["rem"]
            (tok,), (lp,) = self._sample_rows([st["req"]], st["logits"][None])
            self._emit(st["req"], tok, lp)
        self._prefill_s += time.perf_counter() - t0  # sampling synced the device

    def _decode_batch(self) -> None:
        t0 = time.perf_counter()
        bmax = self.cfg.max_batch
        rows = []  # (rid, token, position, page, slot) of surviving requests
        for rid in list(self.running):
            if rid not in self.running:
                continue  # preempted by an earlier row's OOM this step
            req = self.requests[rid]
            page, slot = self._reserve_or_preempt(rid)
            tok = req.output[-1] if req.output else req.prompt[-1]
            rows.append((rid, tok, req.length - 1, page, slot))
        rows = [r for r in rows if r[0] in self.running]
        if not rows:
            return
        batch = [r[0] for r in rows]
        n = len(batch)
        host = np.zeros((4, bmax), np.int64)  # tokens, positions, pages, slots
        host[2] = self.cache.config.num_pages  # inactive slots: dropped write
        for i, (_, tok, pos, page, slot) in enumerate(rows):
            host[:, i] = (tok, pos, page, slot)
        tokens, positions, write_pages, write_slots = torch.from_numpy(host).to(self.device)
        lengths, page_indices = self.cache.batch_view(
            batch + [-1] * (bmax - n), self.cfg.pages_per_seq
        )
        logits = transformer.decode_step(
            self.params, tokens, positions, self.cache.k_pages, self.cache.v_pages,
            lengths, page_indices, write_pages, write_slots, self.model_cfg,
            self.cache.k_scales, self.cache.v_scales,
        )  # the pools are updated in place
        self._n_decode_tokens += n
        self._n_decode_batches += 1
        reqs = [self.requests[r] for r in batch]
        toks, lps = self._sample_rows(reqs, logits[:n])
        self._decode_s += time.perf_counter() - t0
        for req, tok, lp in zip(reqs, toks, lps):
            self._emit(req, tok, lp)

    def _reserve_span(self, n: int) -> dict | None:
        """Reserve n slots for every running request, without preemption.
        Returns each request's cache length before, or None (the
        reservation rolled back with ``trim``) when the pool runs dry."""
        start = {rid: self.cache.length(rid) for rid in self.running}
        try:
            for rid in self.running:
                for _ in range(n):
                    self.cache.reserve_slot(rid)
        except MemoryError:
            for rid in self.running:
                self.cache.trim(rid, start[rid])
            return None
        return start

    def _decode_batch_many(self, n: int) -> bool:
        """Decode n tokens for the whole running batch in one call
        (:func:`transformer.decode_loop`).

        Returns False (the caller steps per token) unless every running
        request has n tokens of budget and engine-default sampling, and n
        cache slots each can be reserved up front without preemption.  A
        request that stops mid-span (eos, stop token, or a callback that
        cancels it) keeps the tokens up to its stop; the rest are dropped
        and its pages freed.  Sampled serving draws from ``sample_gen`` as
        n per-token steps would."""
        for rid in self.running:
            req = self.requests[rid]
            if req.max_new_tokens - len(req.output) < n or req.sampling is not None:
                return False
        t0 = time.perf_counter()
        start = self._reserve_span(n)
        if start is None:
            return False
        bmax = self.cfg.max_batch
        batch = list(self.running)
        host = np.zeros((2, bmax), np.int64)  # tokens, positions (the first write)
        active = np.zeros(bmax, bool)
        for i, rid in enumerate(batch):
            req = self.requests[rid]
            host[:, i] = (req.output[-1] if req.output else req.prompt[-1], start[rid])
            active[i] = True
        tokens, positions = torch.from_numpy(host).to(self.device)
        _, page_indices = self.cache.batch_view(batch + [-1] * (bmax - len(batch)),
                                                self.cfg.pages_per_seq)
        p = self._default_sampling
        sample = {} if p.greedy else dict(
            generator=self.sample_gen, temperature=p.temperature, top_k=p.top_k, top_p=p.top_p)
        out = transformer.decode_loop(
            self.params, tokens, positions, self.cache.k_pages, self.cache.v_pages,
            page_indices, self.model_cfg, n, self.cache.k_scales, self.cache.v_scales,
            active=torch.from_numpy(active), **sample,
        ).cpu().tolist()  # the pools are updated in place
        self._n_decode_batches += n
        self._decode_s += time.perf_counter() - t0
        for i, rid in enumerate(batch):
            req = self.requests[rid]
            for tok in out[i]:
                self._emit(req, tok)
                self._n_decode_tokens += 1
                if req.state != "running":
                    break  # finished or cancelled: its pages are freed
        return True

    def step_speculative(self, draft_fn, k: int) -> None:
        """One continuous-batching step with speculative decoding.

        ``draft_fn(request, n) -> list[int]`` proposes n draft tokens for a
        running request (a small model, an n-gram cache, prompt lookup);
        short lists are padded with 0.  Each request's current token and its
        k - 1 drafts are scored in one call (:func:`transformer.verify_step`);
        the accepted drafts and one token of the model's are emitted (1 to k
        per request), and the rejected drafts' rows are trimmed from the
        cache.  Greedy serving accepts by argmax match
        (:func:`transformer.speculative_accept`); sampled serving by the
        point-mass rejection rule (:func:`sampling.speculative_accept_sampled`),
        which leaves each token distributed as a per-token sample.  Steps
        per token instead when a request has its own sampling params, when
        ``length + k`` would pass the page-table view, or when the k slots
        cannot be reserved."""
        if k < 2:
            raise ValueError("speculative decoding requires k >= 2")
        self._n_steps += 1
        self._admit_and_prefill()
        if not self.running:
            return
        cap_tokens = self.cfg.pages_per_seq * self.cache.config.page_size
        for rid in self.running:
            req = self.requests[rid]
            if (req.max_new_tokens - len(req.output) < 1 or req.sampling is not None
                    or self.cache.length(rid) + k > cap_tokens):
                self._decode_batch()
                return
        t0 = time.perf_counter()
        start = self._reserve_span(k)
        if start is None:
            self._decode_batch()
            return
        bmax = self.cfg.max_batch
        batch = list(self.running)
        ps = self.cache.config.page_size
        fed = np.zeros((bmax, k), np.int64)
        positions = np.zeros(bmax, np.int64)
        write_pages = np.full((bmax, k), self.cache.config.num_pages, np.int64)
        write_slots = np.zeros((bmax, k), np.int64)
        for i, rid in enumerate(batch):
            req = self.requests[rid]
            drafts = list(draft_fn(req, k - 1))[: k - 1]
            fed[i, 0] = req.output[-1] if req.output else req.prompt[-1]
            fed[i, 1:] = drafts + [0] * (k - 1 - len(drafts))
            positions[i] = start[rid]
            pages = self.cache.pages(rid)
            for j in range(k):
                write_pages[i, j] = pages[(start[rid] + j) // ps]
                write_slots[i, j] = (start[rid] + j) % ps
        _, page_indices = self.cache.batch_view(batch + [-1] * (bmax - len(batch)),
                                                self.cfg.pages_per_seq)
        fed_d = torch.from_numpy(fed).to(self.device)
        logits = transformer.verify_step(
            self.params, fed_d, torch.from_numpy(positions).to(self.device),
            self.cache.k_pages, self.cache.v_pages, page_indices,
            torch.from_numpy(write_pages), torch.from_numpy(write_slots),  # host: no sync
            self.model_cfg, self.cache.k_scales, self.cache.v_scales,
        )  # the pools are updated in place
        p = self._default_sampling
        if p.greedy:
            n_emit, emitted = transformer.speculative_accept(fed_d[:, 1:], logits)
        else:
            n_emit, emitted = sampling.speculative_accept_sampled(
                self.sample_gen, fed_d[:, 1:], logits, temperature=p.temperature,
                top_k=p.top_k, top_p=p.top_p,
            )
        n_emit, emitted = n_emit.tolist(), emitted.tolist()
        self._n_spec_steps += 1
        self._spec_s += time.perf_counter() - t0
        for i, rid in enumerate(batch):
            req = self.requests[rid]
            n = min(n_emit[i], req.max_new_tokens - len(req.output))
            self._n_spec_accepted += n - 1
            for tok in emitted[i][:n]:
                self._emit(req, tok)
                self._n_decode_tokens += 1
                if req.state != "running":
                    break  # finished or cancelled: its pages are freed
            if req.state == "running":
                # Keep the rows of the fed token and the accepted drafts, so
                # that the cache holds the emitted length - 1 rows again.
                self.cache.trim(rid, start[rid] + n)

    def _preempt(self, exclude: int) -> bool:
        """Evict the latest-admitted running request (recompute preemption):
        free its pages and requeue it with prompt = everything generated so
        far.  Returns False when nobody but ``exclude`` is running."""
        for rid in reversed(self.running):
            if rid == exclude:
                continue
            req = self.requests[rid]
            req.state = "waiting"
            self.running.remove(rid)
            self.scheduler.finish(rid)
            self.cache.free_sequence(rid)
            self.scheduler.add_request(rid, req.length, req.max_new_tokens - len(req.output))
            self._n_preemptions += 1
            return True
        return False

    # ── sampling ──────────────────────────────────────────────────────────

    def _params_for(self, req: Request) -> SamplingParams:
        return req.sampling if req.sampling is not None else self._default_sampling

    def _seeded(self, p: SamplingParams, req: Request) -> torch.Generator:
        """The request's own stream at its next output position (the JAX
        engine's fold_in(key(seed), position))."""
        return torch.Generator(device=self.device).manual_seed(
            (p.seed * 1_000_003 + len(req.output)) % (1 << 63)
        )

    def _sample(self, logits, p: SamplingParams, gen: torch.Generator) -> torch.Tensor:
        if p.greedy:
            return torch.argmax(logits, dim=-1)  # the first maximum, as jnp.argmax
        return sampling.sample_logits(
            gen, logits, temperature=p.temperature, top_k=p.top_k, top_p=p.top_p
        )

    def _sample_rows(self, reqs: list, logits) -> tuple[list, list]:
        """Per-request sampling over (len(reqs), V) logits rows.

        Rows sharing a filter config batch into one call on the engine's
        generator; seeded rows draw from their own streams.  Returns
        (tokens, logprobs) aligned with ``reqs``."""
        n = len(reqs)
        tokens: list = [0] * n
        groups: dict[tuple, list[int]] = {}
        for i, r in enumerate(reqs):
            p = self._params_for(r)
            if not p.greedy and p.seed is not None:
                tokens[i] = int(self._sample(logits[i], p, self._seeded(p, r)))
            else:
                groups.setdefault(p.filter_key, []).append(i)
        for rows in groups.values():  # dict order: first-seen, stable
            p = self._params_for(reqs[rows[0]])
            idx = torch.tensor(rows, device=logits.device)
            toks = self._sample(logits[idx], p, self.sample_gen).tolist()
            for j, i in enumerate(rows):
                tokens[i] = int(toks[j])
        lps: list = [None] * n
        for i, r in enumerate(reqs):
            if self._params_for(r).logprobs:
                lps[i] = float(torch.log_softmax(logits[i].float(), dim=-1)[tokens[i]])
        return tokens, lps

    def _emit(self, req: Request, token: int, logprob=None) -> None:
        if req.state != "running":
            # A streaming callback may cancel requests mid-batch: later
            # emissions for them in the same step are discarded.
            return
        req.output.append(token)
        p = self._params_for(req)
        if p.logprobs:
            req.logprobs.append(logprob)
        eos = p.eos_token if p.eos_token is not None else self.cfg.eos_token
        done = (
            len(req.output) >= req.max_new_tokens
            or (eos is not None and token == eos)
            or token in p.stop_tokens
        )
        if not done and p.stop_sequences:
            out = req.output
            done = any(
                len(out) >= len(ss) and tuple(out[-len(ss):]) == tuple(ss)
                for ss in p.stop_sequences
            )
        if done:
            req.state = "finished"
            self.running.remove(req.req_id)
            self.scheduler.finish(req.req_id)
            self.cache.free_sequence(req.req_id)
        for cb in (req.on_token, self.on_token):
            if cb is not None:
                cb(req, token)
