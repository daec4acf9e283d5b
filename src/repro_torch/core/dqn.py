"""Deep Q-learning for the provisioner (§2.2, §4.9.2), port of
``repro.core.dqn``: the serving surface of ``DQNLearner``. ``train_on``
comes with the training slice."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.convert import tree_map
from repro_torch.device import resolve_device
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
        self.rng = np.random.default_rng(seed)

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
        reference."""
        states = torch.tensor(np.asarray(state_matrices, np.float32),
                              device=self.device)
        with torch.inference_mode():
            q = q_values(self.params, self.fc, states).cpu().numpy()
        a = np.argmax(q, axis=-1)
        if explore:
            b = len(a)
            flip = self.rng.random(b) < self.dc.epsilon
            a = np.where(flip, self.rng.integers(0, 2, b), a)
        return a.astype(np.int64)
