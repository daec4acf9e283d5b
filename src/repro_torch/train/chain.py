"""Chained sub-job training driver — where the data plane meets Mirage
(port of ``repro.train.chain``).

A ``ChainedTrainer`` runs one SUB-JOB's worth of steps: it resumes from
the latest checkpoint, trains until the wall-clock guard fires (or the
step budget ends), checkpoints, and exits. A chain of such sub-jobs
(provisioned by repro_torch.core's agent so the successor is already
queued when the predecessor dies) is exactly the paper's low-interruption
service.

The weights are drawn from a ``torch.Generator`` seeded with ``seed`` on
``device`` (CUDA unless ``device="cpu"``), so they differ from the
reference's ``jax.random`` draw; a checkpoint written by either package
resumes in the other. Steps run eagerly and return new trees (see
``train.step``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig
from .checkpoint import AsyncCheckpointer, latest_step, restore_checkpoint
from .fault import PreemptionGuard, StragglerMonitor
from .optimizer import OptimizerConfig, init_opt_state
from .step import make_train_step


@dataclasses.dataclass
class ChainConfig:
    ckpt_dir: str = "checkpoints"
    ckpt_every: int = 50
    wall_limit_s: Optional[float] = None     # sub-job limit; None = unlimited
    grace_s: float = 5.0
    max_steps: int = 10**9


class ChainedTrainer:
    def __init__(self, cfg: ModelConfig, ocfg: OptimizerConfig,
                 chain: ChainConfig, data_iter, seed: int = 0,
                 num_microbatches: int = 1, device=None):
        self.cfg, self.ocfg, self.chain = cfg, ocfg, chain
        self.device = resolve_device(device)
        self.data_iter = data_iter
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = transformer.init(gen, cfg)
        self.opt_state = init_opt_state(self.params, ocfg)
        self.step_fn = make_train_step(cfg, ocfg, num_microbatches)
        self.ckpt = AsyncCheckpointer(chain.ckpt_dir)
        self.stragglers = StragglerMonitor()
        self.step = 0

    # ------------------------------------------------------------ resume
    def maybe_resume(self) -> bool:
        s = latest_step(self.chain.ckpt_dir)
        if s is None:
            return False
        state, step = restore_checkpoint(
            self.chain.ckpt_dir, {"params": self.params,
                                  "opt": self.opt_state}, device=self.device)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = step
        return True

    # ------------------------------------------------------------ sub-job
    def run_subjob(self, n_steps: int,
                   guard: Optional[PreemptionGuard] = None) -> Dict:
        """Run (up to) n_steps of one sub-job; returns exit info.

        ``guard`` lets a control plane (repro_torch.core.control.ChainDriver)
        inject its own PreemptionGuard so it can preempt the data plane
        programmatically via ``guard.trigger()``; by default each sub-job
        gets a fresh guard scoped to the chain's wall limit."""
        if guard is None:
            guard = PreemptionGuard(self.chain.wall_limit_s,
                                    self.chain.grace_s,
                                    install_signals=False)
        self.guard = guard
        losses = []
        reason = "budget"
        t_prev = time.monotonic()
        for i in range(n_steps):
            if guard.should_stop():
                reason = "preempted"
                break
            if self.step >= self.chain.max_steps:
                reason = "done"
                break
            batch = next(self.data_iter)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            now = time.monotonic()
            self.stragglers.record(now - t_prev)
            t_prev = now
            losses.append(float(metrics["loss"]))
            if self.step % self.chain.ckpt_every == 0:
                self.ckpt.save(self.step, {"params": self.params,
                                           "opt": self.opt_state})
        # checkpoint at exit: the successor resumes from here
        self.ckpt.save(self.step, {"params": self.params,
                                   "opt": self.opt_state})
        self.ckpt.wait()
        return {"steps_done": self.step, "reason": reason,
                "losses": losses, "stragglers": self.stragglers.flagged}
