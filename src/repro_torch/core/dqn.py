"""Deep Q-learning for the provisioner (§2.2, §4.9.2; Eqs. 2-4), port of
``repro.core.dqn``.

Online on-policy training with experience replay and ε-greedy exploration.
Two credit modes:

* ``paper_credit=True`` (default, Eq. 8): the observed outcome penalty is
  assigned to every action of the episode — Q regression toward the
  episode return (Monte-Carlo-style targets, no bootstrap).
* ``paper_credit=False``: standard one-step TD with a target network,
  ``R + γ·max_a' Q_target(s', a')``, the target computed without gradient.

The parameters are a tree of plain tensors; ``train_on`` takes their
gradient with ``torch.autograd.grad`` and steps them with the port's AdamW,
which returns new trees as the reference's jitted update does. On the card
the trunk's attention and projections differentiate through the flash and
grouped-GEMM backward kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.convert import tree_map
from repro_torch.device import resolve_device
from repro_torch.train.optimizer import (OptimizerConfig, adamw_update,
                                         init_opt_state)
from repro_torch.train.step import value_and_grad  # noqa: F401  (re-export)
from .foundation import FoundationConfig, init_foundation, q_values


@dataclasses.dataclass
class DQNConfig:
    gamma: float = 0.99
    epsilon: float = 0.1
    paper_credit: bool = True
    target_update_every: int = 50
    lr: float = 1e-4
    batch_size: int = 32


class DQNLearner:
    def __init__(self, fc: FoundationConfig, dc: DQNConfig, seed: int = 0,
                 params: Dict = None, device=None):
        self.fc, self.dc = fc, dc
        self.device = resolve_device(device)
        if params is None:
            params = init_foundation(torch.Generator().manual_seed(seed), fc,
                                     device=self.device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.target_params = tree_map(torch.clone, self.params)
        self.ocfg = OptimizerConfig(lr=dc.lr, warmup_steps=10,
                                    total_steps=100_000, weight_decay=0.0,
                                    grad_clip=1.0)
        self.opt_state = init_opt_state(self.params, self.ocfg)
        self.rng = np.random.default_rng(seed)
        self._steps = 0

    def loss(self, params: Dict, batch: Dict[str, torch.Tensor]
             ) -> torch.Tensor:
        """The regression of Q(s, a) on its target (repro/core/dqn.py:54)."""
        q = q_values(params, self.fc, batch["s"])                # (B,2)
        qa = torch.gather(q, 1, batch["a"].long()[:, None])[:, 0]
        if self.dc.paper_credit:
            target = batch["r"]
        else:
            with torch.no_grad():
                q_next = q_values(self.target_params, self.fc, batch["s2"])
                target = batch["r"] + self.dc.gamma * q_next.max(-1).values \
                    * (1.0 - batch["done"].float())
        return torch.mean(torch.square(qa - target))

    # ----------------------------------------------------------- serving
    def act(self, state_matrix: np.ndarray, explore: bool = True) -> int:
        """Deterministic policy (§4.4): submit iff Q(submit) > Q(no-submit);
        ε-greedy exploration during online training. B=1 view of
        ``act_batch``."""
        return int(self.act_batch(state_matrix[None], explore=explore)[0])

    def act_batch(self, state_matrices: np.ndarray,
                  explore: bool = True) -> np.ndarray:
        """Vectorized policy over a (B, k, 40) stack -> (B,) actions: one
        forward on the learner's device decides the whole batch; the
        exploration draws use the same numpy RNG, in the same order, as the
        reference. Nothing made under ``inference_mode`` here outlives the
        call: the returned actions are numpy."""
        states = torch.tensor(np.asarray(state_matrices, np.float32),
                              dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            q = q_values(self.params, self.fc, states).cpu().numpy()
        a = np.argmax(q, axis=-1)
        if explore:
            b = len(a)
            flip = self.rng.random(b) < self.dc.epsilon
            a = np.where(flip, self.rng.integers(0, 2, b), a)
        return a.astype(np.int64)

    # ----------------------------------------------------------- learning
    def train_on(self, batch: Dict[str, np.ndarray]) -> float:
        """One AdamW step on a replay batch; returns the loss."""
        tb = {k: torch.as_tensor(np.asarray(v), device=self.device)
              for k, v in batch.items()}
        loss, grads = value_and_grad(self.loss, self.params, tb)
        self.params, self.opt_state, _ = adamw_update(
            grads, self.params, self.opt_state, self.ocfg)
        self._steps += 1
        if self._steps % self.dc.target_update_every == 0:
            self.target_params = tree_map(torch.clone, self.params)
        return float(loss)
