"""Batched serving example (port of ``examples/serve_decode.py``): the
long-running inference service Mirage keeps alive. Trains a tiny model
briefly so generations aren't pure noise, then serves a batch of requests
through the slot-based engine, on the card (``--device cpu`` for the
CPU).

Usage: PYTHONPATH=src python -m repro_torch.examples.serve_decode \
    [--arch tinyllama-1.1b] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--warm-steps", type=int, default=30)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import torch
    from repro_torch.data import DataConfig, data_iterator
    from repro_torch.device import resolve_device
    from repro_torch.models import registry, transformer
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   make_train_step)

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=True)
    if not cfg.supports_decode:
        raise SystemExit(f"{args.arch} is encoder-only; pick a decoder arch")
    params = transformer.init(torch.Generator(device=dev).manual_seed(0), cfg)

    # brief training so the model predicts the synthetic stream
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg)
    it = data_iterator(cfg, DataConfig(batch=8, seq_len=64), device=dev)
    for i in range(args.warm_steps):
        params, opt, metrics = step(params, opt, next(it))
    loss = float(metrics["loss"])
    print(f"warmed {args.warm_steps} steps, loss={loss:.3f}")

    done, dt = serve(cfg, params, dev)
    toks = sum(len(r.out) for r in done)
    return {"arch": cfg.arch_id, "device": str(dev), "warm_loss": loss,
            "requests": 6, "done": len(done), "tokens": toks,
            "seconds": dt, "outputs": {r.rid: list(r.out) for r in done}}


def serve(cfg, params, dev):
    """Serve the example's 6 requests (prompts of 6 tokens drawn from
    ``default_rng(0)``, 12 new tokens each) through a 4-slot engine with
    ``params`` and print what was served; returns (finished requests,
    seconds)."""
    import torch
    from repro_torch.serve import Request, ServeEngine

    eng = ServeEngine(cfg, params, batch=4, s_max=64, device=dev)
    rng = np.random.default_rng(0)
    for rid in range(6):
        prompt = list(rng.integers(0, cfg.vocab_size, 6))
        eng.add_request(Request(rid=rid, prompt=[int(t) for t in prompt],
                                max_new=12))
    t0 = time.time()
    with torch.inference_mode():
        done = eng.run()
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks/dt:.1f} tok/s batched decode)")
    for r in done[:3]:
        print(f"  req{r.rid}: prompt={r.prompt} -> {r.out}")
    return done, dt


if __name__ == "__main__":
    main()
