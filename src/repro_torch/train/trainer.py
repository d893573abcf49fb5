"""Fault-tolerant training loop, on one device or on a mesh.

Behaviors, all exercised by tests at smoke scale:
  * checkpoint every N steps (atomic, checksummed, optionally async)
  * supervisor loop: a step failure (a simulated node loss) triggers
    re-setup -- with a mesh factory, the mesh is formed again from the ranks
    that are left -- and restore from the newest *valid* checkpoint; corrupt
    checkpoints are skipped automatically
  * elastic re-shard: restore accepts a different mesh (data axis grown or
    shrunk); the state is laid out again by per-leaf shardings
  * straggler mitigation: per-step wall times feed the EWMA monitor; a tripped
    threshold re-plans the layer-DAG schedule with CEFT-CPOP, sweeping on the
    trainer's device (repro_torch.sched)
  * deterministic data: batch i is a pure function of (seed, i) -- restart
    replays the identical stream

Without a mesh factory the loop runs on ``device`` (the card unless
``device="cpu"``); with one, on the mesh it returns (whose device type must
be ``device``'s), the state laid out as ``DTensor``s.  The straggler
re-plans sweep on ``device`` either way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Callable

import numpy as np
import torch

from .. import checkpoint as ckpt_lib
from ..configs.base import ArchConfig, ShapeCell
from ..core.ceft_torch import resolve_device
from ..data.pipeline import DataConfig, SyntheticLM
from ..launch.steps import build_train, input_shardings
from ..models.common import resolve_profile, sharding_profile
from ..optim.adamw import tree_map_sorted
from ..substrate import distribute, mesh_context
from ..models.model import build
from ..sched.layer_dag import build_layer_dag
from ..sched.straggler import StragglerMonitor


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 50
    ckpt_every: int = 10
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_async: bool = False
    seed: int = 0
    fail_at_steps: tuple[int, ...] = ()    # simulated node failures
    max_restarts: int = 3
    straggler_sim: dict | None = None       # {step: (class, slowdown)} simulation
    log_every: int = 10
    peak_lr: float = 5e-3                   # smoke-scale default
    profile: str = "baseline"               # sharding profile, scoped per-trainer


class SimulatedFailure(RuntimeError):
    pass


class Trainer:
    def __init__(self, cfg: ArchConfig, cell: ShapeCell, tcfg: TrainerConfig,
                 mesh_factory: Callable | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.mesh_factory = mesh_factory
        self.cfg = cfg
        self.cell = cell
        self.tcfg = tcfg
        # pinned once; every step below re-enters it
        self.profile = resolve_profile(tcfg.profile)
        self.model = build(cfg)
        self.data = SyntheticLM(DataConfig(cfg.vocab, cell.seq_len,
                                           cell.global_batch, tcfg.seed))
        self.metrics: list[dict] = []
        self.restarts = 0
        g, comp, m, labels = build_layer_dag(cfg, cell)
        self._sched_inputs = (g, comp, m)
        self.monitor = StragglerMonitor(m.P, device=self.device)
        self._setup()

    # ------------------------------------------------------------------ setup
    def _setup(self):
        self._warmup_steps = 1  # the first step after (re)setup is a warm-up
        self.mesh = self.mesh_factory() if self.mesh_factory is not None else None
        if self.mesh is not None and self.mesh.device_type != self.device.type:
            raise ValueError(f"a {self.mesh.device_type} mesh for a {self.device.type} trainer")
        with self._scope():
            self.step_fn, self.opt, self.shardings = build_train(
                self.model, self.mesh, total_steps=self.tcfg.steps, peak_lr=self.tcfg.peak_lr)
            self.in_sh = None if self.mesh is None else input_shardings(
                self.model.input_specs(self.cell), self.mesh)

    def _scope(self):
        """The trainer's profile, and its mesh when it has one."""
        stack = contextlib.ExitStack()
        stack.enter_context(sharding_profile(self.profile))
        if self.mesh is not None:
            stack.enter_context(mesh_context(self.mesh))
        return stack

    def _fresh_state(self):
        params = self.model.init(torch.Generator().manual_seed(self.tcfg.seed), self.device)
        if self.mesh is not None:
            params = tree_map_sorted(distribute, params, self.shardings["params"])
        return params, self.opt.init(params)

    def _batch(self, step: int):
        if self.mesh is None:
            return self.data.device_batch(step, self.device)
        return self.data.sharded_batch(step, self.in_sh)

    # ------------------------------------------------------------- checkpoint
    def _save(self, step, params, opt_state):
        tree = {"params": params, "opt": opt_state}
        ckpt_lib.save(self.tcfg.ckpt_dir, step, tree, async_=self.tcfg.ckpt_async)

    def _restore_latest(self, params_like, opt_like):
        step = ckpt_lib.latest_valid(self.tcfg.ckpt_dir)
        if step is None:
            return 0, None
        sh = None if self.mesh is None else self.shardings
        tree = ckpt_lib.restore(self.tcfg.ckpt_dir, step,
                                {"params": params_like, "opt": opt_like}, sh)
        return step + 1, tree

    # -------------------------------------------------------------------- run
    def run(self) -> list[dict]:
        params, opt_state = self._fresh_state()
        self._save(0, params, opt_state)  # step-0 anchor for recovery
        step = 1
        while step <= self.tcfg.steps:
            try:
                t0 = time.monotonic()
                if step in self.tcfg.fail_at_steps and self.restarts < len(self.tcfg.fail_at_steps):
                    self.restarts += 1
                    raise SimulatedFailure(f"node lost at step {step}")
                batch = self._batch(step - 1)
                with self._scope():
                    params, opt_state, m = self.step_fn(params, opt_state, batch)
                loss = float(m["loss"])
                dt = time.monotonic() - t0
                self._observe_stragglers(step, dt)
                if step % self.tcfg.log_every == 0 or step == self.tcfg.steps:
                    self.metrics.append({"step": step, "loss": loss,
                                         "grad_norm": float(m["grad_norm"]),
                                         "time_s": dt})
                if step % self.tcfg.ckpt_every == 0:
                    self._save(step, params, opt_state)
                step += 1
            except SimulatedFailure as e:
                if self.restarts > self.tcfg.max_restarts:
                    raise
                self.metrics.append({"step": step, "event": f"restart: {e}"})
                self._setup()
                p_like, o_like = self._fresh_state()
                start, tree = self._restore_latest(p_like, o_like)
                if tree is not None:
                    params, opt_state = tree["params"], tree["opt"]
                    step = start
                else:
                    params, opt_state = p_like, o_like
                    step = 1
        self._save(self.tcfg.steps, params, opt_state)
        return self.metrics

    # -------------------------------------------------------------- straggler
    def _observe_stragglers(self, step: int, dt: float):
        if self._warmup_steps > 0:  # a warm-up step's time is not a rate
            self._warmup_steps -= 1
            return
        g, comp, m = self._sched_inputs
        sim = (self.tcfg.straggler_sim or {}).get(step)
        # simulation mode uses a synthetic unit base so the injected slowdown
        # is not masked by wall-clock noise; live mode uses measured times
        base = 1.0 if self.tcfg.straggler_sim is not None else dt
        times = np.ones(m.P) * base
        if sim is not None:
            cls, slow = sim
            times[cls] *= slow
        sched, ev = self.monitor.maybe_replan(step, g, comp, m, times)
        if ev is not None:
            self.metrics.append({
                "step": step, "event": "straggler_replan",
                "class": ev.device_class, "slowdown": round(ev.slowdown, 2),
                "makespan_ratio": round(ev.new_makespan / ev.old_makespan, 3),
            })
