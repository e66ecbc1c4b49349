"""Fault-tolerant LM training loop, after the JAX package's
``repro.train.train_loop``:

  * checkpoint / restart - ``CheckpointManager`` (atomic, checksummed,
                           keep-k, async), resumed from the latest valid
                           step
  * crash simulation     - ``fail_at_step`` raises after that step has
                           run; a rerun resumes
  * straggler watchdog   - a step slower than ``step_timeout_s`` prints a
                           warning
  * microbatching, gradient clipping, int8 optimizer states, loss history

As in the reference, a resumed run draws its batches from the start of the
iterator it is given, not from where the crashed run stopped (ROADMAP.md
queue C). Each step runs eagerly on ``device``.

Over a mesh (``mesh=``, a ``DeviceMesh`` of more than one position; every
rank calls ``train`` with the same arguments) every rank draws the same
full init from ``seed`` and keeps its shards (``train.steps.TrainPlan``),
a checkpoint is resumed onto the shards, each step is the sharded
``make_train_step`` (bitwise the single-device step at ``microbatches``
times the batch positions, see ``train.steps``), and each checkpoint is
the logical state, written by one rank (``train.checkpoint``): the same
bytes as the single-device loop's at the same step. ``fail_at_step``
raises on every rank after that step; the watchdog warns per rank; the
mesh's origin rank logs the losses.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator

import torch

from repro_torch.models import transformer_lm as TLM
from repro_torch.models.transformer_lm import ArchConfig
from repro_torch.nn.module import resolve_device
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (DEFAULT_RULES, ShardingRules,
                                           mesh_positions)
from repro_torch.train import steps as ST
from repro_torch.train.checkpoint import CheckpointManager


def _quiet(*args, **kwargs) -> None:
    pass


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    microbatches: int = 1
    step_timeout_s: float = 0.0        # 0 = watchdog off
    fail_at_step: int = -1             # fault injection for tests
    qat: bool = False


def train(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, tcfg: TrainConfig,
          batches: Iterator[Dict[str, Any]],
          rules: ShardingRules = DEFAULT_RULES, seed: int = 0,
          device="cuda", mesh=None) -> Dict[str, Any]:
    """Returns {params, opt_state, losses, resumed_from}. ``batches``
    yields {"tokens", "labels"} of (B, S) integer arrays or tensors,
    moved to ``device`` per step. Params come from the port's init at
    ``seed`` unless a checkpoint of ``tcfg.ckpt_dir`` replaces them. Over
    a ``mesh`` params and opt_state are this rank's shards, and ``specs``
    ({"params", "opt"}) their storage specs."""
    dev = resolve_device(device)
    mgr = CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep)
    step_fn = ST.make_train_step(cfg, opt_cfg, rules,
                                 num_microbatches=tcfg.microbatches,
                                 qat=tcfg.qat, mesh=mesh)
    params = TLM.init(cfg, torch.Generator().manual_seed(seed), device=dev)
    say = print
    if mesh_positions(mesh) > 1:
        if any(mesh.get_local_rank(a) for a in mesh.mesh_dim_names):
            say = _quiet                        # one rank logs
        plan = step_fn.plan
        params = plan.shard_params(params)
        opt_state = plan.init_state(dev)
        specs = plan.specs
    else:
        mesh = specs = None
        opt_state = adamw.init(params, opt_cfg)
    start_step = 0
    resumed_from = None

    latest = mgr.latest_step()
    if latest is not None:
        step, restored = mgr.restore_latest(
            {"params": params, "opt": opt_state}, specs, mesh)
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start_step = step
            resumed_from = step
            say(f"[train] resumed from checkpoint step {step}")

    losses = []
    it = iter(batches)
    try:
        for step in range(start_step, tcfg.steps):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in next(it).items()}
            t0 = time.time()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if step == tcfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            if tcfg.step_timeout_s and \
                    (time.time() - t0) > tcfg.step_timeout_s:
                print(f"[train][WARN] step {step} exceeded "
                      f"{tcfg.step_timeout_s}s (straggler watchdog)")
            loss = float(metrics["loss"])
            losses.append(loss)
            if step % tcfg.log_every == 0:
                say(f"[train] step {step:5d} loss {loss:.4f} "
                      f"({time.time() - t0:.2f}s)")
            if tcfg.ckpt_every and (step + 1) % tcfg.ckpt_every == 0:
                mgr.save(step + 1, {"params": params, "opt": opt_state},
                         specs, mesh)
    finally:
        # a save still being written when a step raises is published
        # before the exception leaves, so that a rerun in the same
        # process finds it
        mgr.wait()
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "resumed_from": resumed_from, "specs": specs}
