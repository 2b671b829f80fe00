"""Rank processes of ``tests/test_torch_parallel_serving.py``.

A spawned child re-imports the module of its target, so the rank body lives
here, in a module that imports only the port (no JAX, no conftest).
:func:`spawn` starts a dp x tp world of gloo ranks on the CPU joined over a
``FileStore``, each running :func:`rank_main` on the cases the parent wrote,
and returns each rank's results; a rank that fails or hangs fails the call.

Cases (plain dicts of numpy arrays, global tensors; page ids local to the
dp slice):
- ``attention``: ``make_sharded_paged_attention`` on the rank's shards of q,
  the pools, lengths and the page table (``dtype`` names q's and the pools'
  dtype when they are not int8);
- ``step``: ``make_sharded_decode_step`` on the rank's ``shard_params`` of
  the tree and its shards of the step's inputs: the logits and the pools
  after the step;
- ``single``: the step on a TP group of this rank alone, whole parameters
  and inputs (global page ids), against ``decode_step`` on the same
  inputs, bit for bit;
- ``indivisible``: a config whose KV heads the TP group does not divide:
  the step's error.
"""

from __future__ import annotations

import datetime
import os
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from flashattention_tpu_torch.models import transformer
from flashattention_tpu_torch.models.train.common import shard_params
from flashattention_tpu_torch.parallel import serving

TIMEOUT_S = 120


def _t(x, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t if dtype is None else t.to(getattr(torch, dtype))


def _attention(case, coords, group, single):
    dt = case.get("dtype")
    pool_dt = None if case["k_pages"].dtype == np.int8 else dt
    fn = serving.make_sharded_paged_attention(scale=case["scale"], quantized="k_scales" in case)
    args = [serving.local_shard(_t(case["q"], dt), serving.Q_SPEC, coords),
            *(serving.local_shard(_t(case[k], pool_dt), serving.POOL_SPEC, coords)
              for k in ("k_pages", "v_pages")),
            serving.local_shard(_t(case["lengths"]), serving.VEC_SPEC, coords),
            serving.local_shard(_t(case["page_indices"]), serving.TABLE_SPEC, coords)]
    if "k_scales" in case:
        args += [serving.local_shard(_t(case[k]), serving.SCALE_SPEC, coords)
                 for k in ("k_scales", "v_scales")]
    return {"out": fn(*args).float().numpy()}


def _step_inputs(case, cfg, coords):
    pools = [serving.local_shard(_t(case[k]), serving.POOLS_SPEC, coords)
             for k in ("k_pages", "v_pages")]
    scales = [serving.local_shard(_t(case[k]), serving.SCALES_SPEC, coords)
              for k in ("k_scales", "v_scales") if k in case]
    vecs = {k: serving.local_shard(_t(case[k]), serving.VEC_SPEC, coords)
            for k in ("tokens", "positions", "lengths", "write_pages", "write_slots")}
    table = serving.local_shard(_t(case["page_indices"]), serving.TABLE_SPEC, coords)
    return pools, scales, vecs, table


def _step(case, coords, group, single):
    cfg = transformer.ModelConfig(**case["cfg"])
    tp_index, tp_size = coords["tp"]
    params = shard_params(transformer.params_from_jax(case["params"], device="cpu"), cfg,
                          tp_index, tp_size)
    (kp, vp), scales, vecs, table = _step_inputs(case, cfg, coords)
    step = serving.make_sharded_decode_step(cfg, tp_group=group, quantized=bool(scales))
    logits = step(params, vecs["tokens"], vecs["positions"], kp, vp, vecs["lengths"], table,
                  vecs["write_pages"], vecs["write_slots"], *scales)
    out = {"logits": logits.numpy(), "k_pages": kp.numpy(), "v_pages": vp.numpy()}
    if scales:
        out.update(k_scales=scales[0].numpy(), v_scales=scales[1].numpy())
    return out


def _single(case, coords, group, single):
    """The whole step on a TP group of one, against ``decode_step``."""
    cfg = transformer.ModelConfig(**case["cfg"])
    params = transformer.params_from_jax(case["params"], device="cpu")
    whole = {"dp": (0, 1), "tp": (0, 1)}
    runs = []
    for sharded in (True, False):
        (kp, vp), _, vecs, table = _step_inputs(case, cfg, whole)
        args = (params, vecs["tokens"], vecs["positions"], kp, vp, vecs["lengths"], table,
                vecs["write_pages"], vecs["write_slots"])
        if sharded:
            logits = serving.make_sharded_decode_step(cfg, tp_group=single)(*args)
        else:
            logits = transformer.decode_step(*args, cfg)
        runs.append((logits, kp, vp))
    return {"bitwise": all(torch.equal(a, b) for a, b in zip(*runs)),
            "group_size": dist.get_world_size(single)}


def _indivisible(case, coords, group, single):
    cfg = transformer.ModelConfig(**case["cfg"])
    try:
        serving.make_sharded_decode_step(cfg, tp_group=group)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


RUNNERS = {"attention": _attention, "step": _step, "single": _single,
           "indivisible": _indivisible}


def rank_main(rank: int, dp: int, tp: int, store: str, cases_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=dp * tp,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        dp_index, tp_index, group = serving.tp_groups(dp, tp)
        singles = [dist.new_group([r]) for r in range(dp * tp)]
        coords = {"dp": (dp_index, dp), "tp": (tp_index, tp)}
        cases = torch.load(cases_path, weights_only=False)
        out = {name: RUNNERS[case["kind"]](case, coords, group, singles[rank])
               for name, case in cases.items()}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def spawn(cases: dict, tmp_dir: str, dp: int = 2, tp: int = 2) -> list[dict]:
    """Run ``cases`` on a dp x tp world of spawned gloo ranks; the results
    of each rank, in rank order.  Raises if a rank fails or outlives the
    timeout (and then kills the rest)."""
    cases_path = os.path.join(tmp_dir, "cases.pt")
    torch.save(cases, cases_path)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, dp, tp, os.path.join(tmp_dir, "store"),
                                                 cases_path, tmp_dir))
             for r in range(dp * tp)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + TIMEOUT_S + 60
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {}
    for r, p in enumerate(procs):
        err = os.path.join(tmp_dir, f"rank{r}.err")
        if p.exitcode != 0:
            errors[r] = open(err).read() if os.path.exists(err) else f"exit code {p.exitcode}"
    if hung or errors:
        raise RuntimeError(f"ranks hung: {hung}; ranks failed: {errors}")
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(dp * tp)]
