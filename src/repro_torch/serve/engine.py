"""Batched serving engine: slot-based continuous batching (port of
``repro.serve.engine``).

Requests occupy slots of a fixed decode batch; finished slots are refilled
from the queue, and a new slot's prompt is fed through per-slot decode
steps. The reference vmaps a single-sequence decode over the slots, each at
its own cache index. The port makes one batched ``decode_step`` with the
slots' indices as a (batch,) tensor: each row writes its K/V, or MLA's
latents, at its own slot and masks its own length (``attn_decode``,
``mla_decode``), and ``mamba_decode`` reads no index, so every row of the
batched step is that row's single-sequence decode. Merging back only the slots that were meant to
advance then computes what the reference computes.

One deliberate divergence: a slot refilled from the queue has every row of
its cache cleared before its prompt is fed. The reference only resets the
slot's length, which masks stale attention rows but not a Mamba block's
SSM state and conv taps: there the next request would start from the
previous request's state. Attention-only models give the reference's
tokens either way; Mamba2 and Zamba2 give, in a reused slot, the tokens of
the request served alone.

This is the long-running inference service Mirage keeps alive across
chained sub-jobs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.convert import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, batch: int = 4,
                 s_max: int = 256, eos_id: Optional[int] = None, device=None):
        if not cfg.supports_decode:
            raise ValueError(f"{cfg.arch_id} is encoder-only")
        self.cfg, self.params = cfg, params
        self.batch, self.s_max = batch, s_max
        self.eos_id = eos_id
        self.device = resolve_device(device)
        self.cache = transformer.init_cache(cfg, batch, s_max,
                                            device=self.device)
        self.lengths = np.zeros(batch, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * batch
        self.queue: List[Request] = []

    def _decode(self, toks: np.ndarray, idxs: np.ndarray):
        """One decode step over every slot, each at its own index:
        (logits (batch, V), cache)."""
        tok = torch.from_numpy(toks.astype(np.int64)).to(self.device)[:, None]
        idx = torch.from_numpy(idxs.astype(np.int64)).to(self.device)
        pos = idx[:, None]
        if self.cfg.mrope_sections:     # text: the three streams equal
            pos = pos.expand(3, -1, -1)
        return transformer.decode_step(self.params, self.cfg, tok, pos,
                                       self.cache, idx)

    # ----------------------------------------------------------- requests
    def add_request(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> List[int]:
        admitted = []
        for slot in range(self.batch):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                self.slot_req[slot] = req
                self.lengths[slot] = 0
                # every cache starts at zeros (init_cache): zero the
                # slot's row of each leaf (axis 1, after the layer axis)
                tree_map(lambda t: t[:, slot].zero_(), self.cache)
                self._prefill_slot(slot, req)
                admitted.append(slot)
        return admitted

    def _prefill_slot(self, slot: int, req: Request) -> None:
        """Feed the prompt through per-slot decode steps. Only this slot's
        cache rows are merged back, so concurrent slots are untouched."""
        for i, t in enumerate(req.prompt[:-1]):
            toks = np.zeros(self.batch, np.int32)
            toks[slot] = t
            idxs = np.zeros(self.batch, np.int32)
            idxs[slot] = i
            _, cache = self._decode(toks, idxs)
            _merge_slots(self.cache, cache, [slot])
        self.lengths[slot] = max(len(req.prompt) - 1, 0)

    # --------------------------------------------------------------- step
    def step(self) -> int:
        """One tick: admit waiting requests, decode one token per live slot."""
        self._admit()
        live = [s for s in range(self.batch) if self.slot_req[s] is not None]
        if not live:
            return 0
        toks = np.zeros(self.batch, np.int32)
        idxs = np.zeros(self.batch, np.int32)
        for s in live:
            req = self.slot_req[s]
            toks[s] = req.out[-1] if req.out else req.prompt[-1]
            idxs[s] = self.lengths[s]
        logits, cache = self._decode(toks, idxs)
        _merge_slots(self.cache, cache, live)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for s in live:
            req = self.slot_req[s]
            tok = int(nxt[s])
            req.out.append(tok)
            self.lengths[s] += 1
            if (len(req.out) >= req.max_new
                    or (self.eos_id is not None and tok == self.eos_id)
                    or self.lengths[s] >= self.s_max - 1):
                req.done = True
                self.slot_req[s] = None
                self.lengths[s] = 0
        return len(live)

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        # snapshot everything in flight: queued requests and requests
        # already admitted to slots before run() was called
        known: List[Request] = ([r for r in self.slot_req if r is not None]
                                + list(self.queue))
        for _ in range(max_ticks):
            if not self.queue and all(r is None for r in self.slot_req):
                break
            self.step()
        return [r for r in known if r.done]


def _merge_slots(dst, src, slots: List[int]) -> None:
    """Write the rows ``slots`` (axis 1, after the layer axis) of every leaf
    of ``src`` into ``dst``, in place: the engine owns ``dst``, and
    ``decode_step`` never writes the cache it is given."""
    if isinstance(dst, dict):
        for k in dst:
            _merge_slots(dst[k], src[k], slots)
    elif isinstance(dst, list):
        for d, s in zip(dst, src):
            _merge_slots(d, s, slots)
    else:
        idx = torch.tensor(slots, device=dst.device)
        dst[:, idx] = src[:, idx]
