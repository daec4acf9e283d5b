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
resumes in the other. Steps run eagerly. As the reference jits its step
with ``donate_argnums=(0, 1)``, the trainer's step owns ``params`` and
``opt_state`` (``make_train_step(..., donate=True)``): each leaf's new p,
m and v are written into its own storage, the bits of the functional
update. A checkpoint's host snapshot is taken when ``save`` is called,
before the next step writes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from repro_torch.convert import tree_map
from repro_torch.device import resolve_device
from repro_torch.dist import sharding as shd
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
                 num_microbatches: int = 1, device=None, mesh=None):
        """``mesh``: a ``DeviceMesh`` over the running process group whose
        "model" axis is 1 (``launch.mesh.make_host_mesh``): a resume
        places the checkpoint's leaves on it by the sharding rules
        (``restore_checkpoint(shardings=)``) and trains on this rank's
        shards, which on such a mesh are the whole leaves, one replica a
        rank."""
        self.cfg, self.ocfg, self.chain = cfg, ocfg, chain
        self.mesh = mesh
        self.device = resolve_device(device)
        self.data_iter = data_iter
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = transformer.init(gen, cfg)
        self.opt_state = init_opt_state(self.params, ocfg)
        self.step_fn = make_train_step(cfg, ocfg, num_microbatches,
                                       donate=True)
        self.ckpt = AsyncCheckpointer(chain.ckpt_dir)
        self.stragglers = StragglerMonitor()
        self.step = 0
        self._saved_step = None     # the newest step handed to the writer

    # ------------------------------------------------------------ resume
    def maybe_resume(self) -> bool:
        s = latest_step(self.chain.ckpt_dir)
        if s is None:
            return False
        template = {"params": self.params, "opt": self.opt_state}
        if self.mesh is None:
            state, step = restore_checkpoint(self.chain.ckpt_dir, template,
                                             device=self.device)
        else:
            state, step = restore_checkpoint(
                self.chain.ckpt_dir, template,
                shardings=self._shardings(template))
            state = tree_map(lambda t: t.to_local(), state)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = self._saved_step = step
        return True

    def _shardings(self, template):
        """(mesh, placements) of every leaf of {"params", "opt"} by the
        reference's rules on ``self.mesh``."""
        if shd.axis_size(self.mesh, "model") != 1:
            raise ValueError("ChainedTrainer trains whole replicas: its "
                             "mesh's model axis must be 1")
        return {"params": shd.to_shardings(self.mesh, shd.params_pspecs(
                    self.cfg, template["params"], self.mesh)),
                "opt": shd.to_shardings(self.mesh, shd.opt_state_pspecs(
                    self.cfg, template["opt"], self.mesh))}

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
                self._save()
        # checkpoint at exit: the successor resumes from here. Its wall
        # time, until the shard is durable, is what the guard's grace must
        # cover beside the last step; a step already handed to the writer
        # is not written twice
        t0 = time.monotonic()
        if self._saved_step != self.step:
            self._save()
        self.ckpt.wait()
        return {"steps_done": self.step, "reason": reason,
                "losses": losses, "stragglers": self.stragglers.flagged,
                "exit_ckpt_s": time.monotonic() - t0}

    def _save(self) -> None:
        self.ckpt.save(self.step, {"params": self.params,
                                   "opt": self.opt_state})
        self._saved_step = self.step
