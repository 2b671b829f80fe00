"""The port's C++ runtime core (``flashattention_tpu_torch/csrc/fa_runtime.cc``
bound by ``flashattention_tpu_torch/runtime/native.py``) against the JAX
package's binding of its own core and against the port's pure-Python copy
(``native=False``).

- The core builds here with ``g++`` and is what ``PageAllocator`` and
  ``Scheduler`` run on by default; the engine and the paged cache get it.
- Over seeded random op sequences (alloc / free; add / admit / finish /
  cancel, with and without ``reserve_worst_case``, with and without
  ``max_out``) the three agree op for op: the same pages, the same admitted
  ids, the same counts.
- A build that fails (a missing compiler, a source that does not compile)
  raises ``NativeBuildError`` with the compiler's words: the port never
  falls back quietly, as the JAX binding does.
- The engine gives the same greedy tokens on the core and on the copy, and
  an interpreter holding live allocators and schedulers exits cleanly.
"""

import dataclasses
import functools
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from flashattention_tpu.runtime import native as jn
from flashattention_tpu_torch.models import transformer as tt
from flashattention_tpu_torch.runtime import engine as te
from flashattention_tpu_torch.runtime import kvcache as tk
from flashattention_tpu_torch.runtime import native as tn

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_core_is_the_default():
    assert tn.PageAllocator(16).native and tn.Scheduler(4, 8).native
    assert not tn.PageAllocator(16, native=False).native
    assert not tn.Scheduler(4, 8, native=False).native
    assert isinstance(tn.PageAllocator(4, native=False), tn.PlainPageAllocator)
    assert isinstance(tn.Scheduler(4, 8, native=False), tn.PlainScheduler)
    # The port's own source and build directory, never the JAX package's.
    assert tn.SOURCE == os.path.join(ROOT, "flashattention_tpu_torch", "csrc", "fa_runtime.cc")
    assert os.path.dirname(tn.library()._name) == tn.BUILD_DIR
    assert tn.BUILD_DIR == os.path.join(ROOT, "build", "torch_runtime")
    # The JAX binding this file holds the port to is its C++ core too.
    assert jn.PageAllocator(4).native and jn.Scheduler(4, 8).native


def test_engine_and_cache_run_on_the_core():
    cfg = dataclasses.replace(tt.ModelConfig.tiny(), dtype="float32")
    cc = tk.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8, num_pages=8,
                        dtype="float32")
    eng = te.Engine(tt.init_params(0, cfg, device="cpu"), cfg, cc, device="cpu")
    assert eng.scheduler.native and eng.cache.allocator.native


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("num_pages", [1, 16, 64])
def test_allocator_three_ways(seed, num_pages):
    rng = np.random.default_rng(seed * 7 + num_pages)
    allocs = [jn.PageAllocator(num_pages), tn.PageAllocator(num_pages),
              tn.PageAllocator(num_pages, native=False)]
    held = []
    for _ in range(200):
        if held and rng.random() < 0.45:
            pages = held.pop(int(rng.integers(len(held))))
            for a in allocs:
                a.free(pages)
        else:
            n = int(rng.integers(0, max(2, num_pages // 3)))
            got = [a.alloc(n) for a in allocs]
            assert got[0] == got[1] == got[2]
            if got[0]:
                held.append(got[0])
        assert len({a.num_free() for a in allocs}) == 1


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("reserve", [False, True])
@pytest.mark.parametrize("max_batch,page_size", [(1, 4), (4, 8), (8, 16)])
def test_scheduler_three_ways(seed, reserve, max_batch, page_size):
    rng = np.random.default_rng(1000 * seed + 10 * max_batch + int(reserve))
    scheds = [jn.Scheduler(max_batch, page_size, reserve_worst_case=reserve),
              tn.Scheduler(max_batch, page_size, reserve_worst_case=reserve),
              tn.Scheduler(max_batch, page_size, reserve_worst_case=reserve, native=False)]
    running, next_id = [], 0
    for _ in range(150):
        op = rng.random()
        if op < 0.35:
            plen, new = int(rng.integers(1, 5 * page_size)), int(rng.integers(1, 3 * page_size))
            for s in scheds:
                s.add_request(next_id, plen, new)
            next_id += 1
        elif op < 0.65:
            budget = int(rng.integers(0, 24))
            max_out = None if rng.random() < 0.5 else int(rng.integers(0, max_batch + 2))
            got = [s.admit(budget, max_out) for s in scheds]
            assert got[0] == got[1] == got[2]
            running += got[0]
        elif running and op < 0.85:
            r = running.pop(int(rng.integers(len(running))))
            for s in scheds:
                s.finish(r)
        else:
            r = int(rng.integers(0, next_id + 2))  # an unknown id now and then
            got = [s.cancel(r) for s in scheds]
            assert got[0] == got[1] == got[2]
            if r in running:
                running.remove(r)
        assert len({(s.num_waiting(), s.num_running()) for s in scheds}) == 1


def test_build_failure_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tn, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(tn, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(tn.NativeBuildError, match="no-such-compiler"):
        tn.build()
    # At first use: the allocator and the scheduler raise, never fall back.
    monkeypatch.setattr(tn, "_lib", None)
    with pytest.raises(tn.NativeBuildError, match="no-such-compiler"):
        tn.PageAllocator(4)
    with pytest.raises(tn.NativeBuildError, match="no-such-compiler"):
        tn.Scheduler(4, 8)
    assert tn.PageAllocator(4, native=False).alloc(2) == [0, 1]


def test_compile_error_names_the_compiler_error(tmp_path, monkeypatch):
    src = tmp_path / "fa_runtime.cc"
    shutil.copy(tn.SOURCE, src)
    monkeypatch.setattr(tn, "SOURCE", str(src))
    monkeypatch.setattr(tn, "BUILD_DIR", str(tmp_path))
    first = tn.build()
    assert not first["cached"] and tn.build()["cached"]
    src.write_text(src.read_text() + "\nint fa_broken( {\n")
    with pytest.raises(tn.NativeBuildError, match="error"):
        tn.build()
    # An edit is a new library name: the old build is never taken for it.
    src.write_text(src.read_text().replace("\nint fa_broken( {\n", "\n// edited\n"))
    again = tn.build()
    assert not again["cached"] and again["path"] != first["path"]


def test_engine_tokens_with_and_without_the_core(monkeypatch):
    """Page pressure (preemption and re-admission) and a cancel: the same
    greedy tokens and stats on the core and on the pure-Python copy."""
    cfg = dataclasses.replace(tt.ModelConfig.tiny(), dtype="float32")
    params = tt.init_params(3, cfg, device="cpu")
    cc = tk.CacheConfig(num_layers=2, num_kv_heads=2, head_dim=32, page_size=8, num_pages=6,
                        dtype="float32")
    runs = []
    for native in (True, False):
        if not native:
            monkeypatch.setattr(te, "Scheduler", functools.partial(tn.Scheduler, native=False))
            monkeypatch.setattr(tk, "PageAllocator", functools.partial(tn.PageAllocator,
                                                                       native=False))
        eng = te.Engine(params, cfg, cc, te.EngineConfig(max_batch=3, pages_per_seq=4,
                                                         prefill_chunk=0), device="cpu")
        assert eng.scheduler.native == native and eng.cache.allocator.native == native
        ids = [eng.add_request([1 + i, 2, 3, 4, 5, 6, 7][: 3 + i], 14) for i in range(4)]
        eng.step()
        eng.cancel(ids[1])
        out = eng.run()
        st = eng.stats()
        assert st["preemptions"] > 0 and eng.cache.num_free_pages() == cc.num_pages
        runs.append(([out[i] for i in ids], st["preemptions"], st["decode_tokens"]))
    assert runs[0] == runs[1]


def test_interpreter_exits_cleanly_with_live_objects():
    code = (
        "from flashattention_tpu_torch.runtime import native\n"
        "A = native.PageAllocator(8)\n"
        "S = native.Scheduler(2, 4)\n"
        "A.alloc(3); S.add_request(0, 5, 2); S.admit(8)\n"
        "CYCLE = [A, S]; CYCLE.append(CYCLE)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                          timeout=120, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
    assert proc.stderr == ""

