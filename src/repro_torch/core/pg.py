"""Policy gradient (REINFORCE) for the provisioner (§2.3, Eqs. 5-6), port
of ``repro.core.pg``.

The P-head outputs submit/no-submit probabilities; actions are sampled
(non-deterministic policy, §4.4). The Monte-Carlo gradient uses whole
episodes with the shaped episode return (Eq. 8) and a running-mean
baseline for variance reduction.
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
from .dqn import value_and_grad
from .foundation import FoundationConfig, init_foundation, policy_logits


@dataclasses.dataclass
class PGConfig:
    lr: float = 1e-4
    entropy_coef: float = 0.01
    baseline_momentum: float = 0.9


class PGLearner:
    def __init__(self, fc: FoundationConfig, pc: PGConfig, seed: int = 0,
                 params: Dict = None, device=None):
        self.fc, self.pc = fc, pc
        self.device = resolve_device(device)
        if params is None:
            params = init_foundation(torch.Generator().manual_seed(seed), fc,
                                     device=self.device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.ocfg = OptimizerConfig(lr=pc.lr, warmup_steps=10,
                                    total_steps=100_000, weight_decay=0.0,
                                    grad_clip=1.0)
        self.opt_state = init_opt_state(self.params, self.ocfg)
        self.rng = np.random.default_rng(seed)
        self.baseline = 0.0

    def loss(self, params: Dict, states, actions, advantage, mask
             ) -> torch.Tensor:
        """REINFORCE with an entropy bonus over the unmasked steps
        (repro/core/pg.py:46)."""
        logits = policy_logits(params, self.fc, states)           # (T,2)
        logp = torch.log_softmax(logits, -1)
        lp_a = torch.gather(logp, 1, actions.long()[:, None])[:, 0]
        denom = torch.clamp(mask.sum(), min=1.0)
        entropy = (-torch.sum(torch.exp(logp) * logp, -1) * mask).sum() \
            / denom
        return (-(lp_a * advantage * mask).sum() / denom
                - self.pc.entropy_coef * entropy)

    # ----------------------------------------------------------- serving
    def act(self, state_matrix: np.ndarray, explore: bool = True) -> int:
        """Sample from the output binomial distribution (§4.4). B=1 view
        of ``act_batch``."""
        return int(self.act_batch(state_matrix[None], explore=explore)[0])

    def act_batch(self, state_matrices: np.ndarray,
                  explore: bool = True) -> np.ndarray:
        """Vectorized sampling over a (B, k, 40) stack -> (B,) actions, with
        the reference's numpy draws in its order; nothing made under
        ``inference_mode`` outlives the call."""
        states = torch.tensor(np.asarray(state_matrices, np.float32),
                              dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            logits = policy_logits(self.params, self.fc, states)
            p = torch.softmax(logits, -1).cpu().numpy()
        if explore:
            u = self.rng.random(len(p))
            return (u < p[:, 1]).astype(np.int64)
        return np.argmax(p, axis=-1).astype(np.int64)

    # ----------------------------------------------------------- learning
    def train_on_episode(self, states: np.ndarray, actions: np.ndarray,
                         episode_return: float, pad_to: int = 32) -> float:
        """states: (T, k, 40); actions: (T,); the shaped return credits
        every action of the trajectory (Eq. 6 with r(tau)). Episodes are
        padded to multiples of ``pad_to``, as the reference pads them so
        that its jitted update does not retrace: padded steps run through
        the trunk with mask 0 and add nothing to the loss."""
        self.baseline = (self.pc.baseline_momentum * self.baseline
                         + (1 - self.pc.baseline_momentum) * episode_return)
        adv = episode_return - self.baseline
        T = len(actions)
        Tp = max(-(-T // pad_to) * pad_to, pad_to)
        sp = np.zeros((Tp,) + states.shape[1:], np.float32)
        sp[:T] = states
        ap = np.zeros((Tp,), np.int32)
        ap[:T] = actions
        mask = np.zeros((Tp,), np.float32)
        mask[:T] = 1.0
        dev = self.device
        loss, grads = value_and_grad(
            self.loss, self.params, torch.from_numpy(sp).to(dev),
            torch.from_numpy(ap).to(dev),
            torch.full((Tp,), adv, dtype=torch.float32, device=dev),
            torch.from_numpy(mask).to(dev))
        self.params, self.opt_state, _ = adamw_update(
            grads, self.params, self.opt_state, self.ocfg)
        return float(loss)
