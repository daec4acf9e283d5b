"""Synthetic token pipeline: seeded, restartable (port of
``repro.data.pipeline``).

Deterministic per-step batches (a seeded hash of (seed, step)) so a
resumed sub-job regenerates exactly the stream it would have seen — data
restartability is part of the checkpoint/resume contract. The numpy stream
is the reference's, draw for draw, so a batch here equals JAX's bit for
bit; it is handed over as int32 (or fp32 frame embeddings) torch tensors on
``device`` (CUDA unless ``device="cpu"``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class DataConfig:
    batch: int = 8
    seq_len: int = 128
    seed: int = 0
    # structured synthetic language: token t+1 = f(token t) mixture, so a
    # model can actually LEARN it (loss visibly decreases in examples)
    n_patterns: int = 31


def synth_batch(cfg: ModelConfig, dc: DataConfig, step: int,
                device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    rng = np.random.default_rng(np.uint64(dc.seed * 1_000_003 + step))
    B, S, V = dc.batch, dc.seq_len, cfg.vocab_size
    # Markov-ish stream: next = (cur * a + b) % V with per-sequence (a, b)
    a = rng.integers(1, dc.n_patterns, (B, 1))
    b = rng.integers(0, dc.n_patterns, (B, 1))
    x0 = rng.integers(0, V, (B, 1))
    toks = np.empty((B, S + 1), np.int64)
    toks[:, :1] = x0
    for t in range(S):
        toks[:, t + 1] = (toks[:, t] * a[:, 0] + b[:, 0]) % V
    noise = rng.random((B, S + 1)) < 0.02
    toks[noise] = rng.integers(0, V, noise.sum())
    inputs = toks[:, :-1].astype(np.int32)
    labels = toks[:, 1:].astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    if cfg.mrope_sections:
        pos = np.broadcast_to(pos[None], (3, B, S)).copy()
    batch = {"inputs": inputs, "labels": labels, "positions": pos}
    if not cfg.embed_inputs:   # audio: frame embeddings instead of tokens
        batch["inputs"] = rng.standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def data_iterator(cfg: ModelConfig, dc: DataConfig, start_step: int = 0,
                  device=None) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield synth_batch(cfg, dc, step, device=device)
        step += 1
