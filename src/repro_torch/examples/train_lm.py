"""End-to-end training driver (port of ``examples/train_lm.py``): train a
~100M-param model for a few hundred steps on the synthetic-language
pipeline, with checkpointing, preemption guard, and straggler monitoring —
the exact loop a chained sub-job runs, on the card (``--device cpu`` for
the CPU).

Usage:
  PYTHONPATH=src python -m repro_torch.examples.train_lm \
      [--arch tinyllama-1.1b] [--steps 300] [--d-model 512] [--layers 8] \
      [--device cpu]

The config is the selected arch's family scaled to ~100M params (CPU
feasible); loss on the learnable synthetic stream drops from ~ln(V) to
well below it within a few hundred steps. As in the reference, the
attention is ``attn_impl="chunked"``, the flash-style scan over kv chunks
(``models.attention.attention_chunked``). A second invocation with the same ``--ckpt-dir`` resumes from
the first one's last step and continues the data stream there, as both
packages' ``launch/train.py`` do. The reference example restarts the
stream at step 0 on a resume, a deliberate divergence here: a resumed
sub-job then retrains the first batches, and at small sizes its loss rises
and fails the example's own check.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    # CPU-sized defaults; on real hardware use e.g. --d-model 768 --layers 12
    # --batch 64 --seq 1024 for the ~100M-param configuration.
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--ckpt-dir", default="checkpoints/train_lm")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.data import DataConfig, data_iterator
    from repro_torch.device import resolve_device
    from repro_torch.models import registry, transformer
    from repro_torch.train import (ChainConfig, ChainedTrainer,
                                   OptimizerConfig)

    dev = resolve_device(args.device)
    base = registry.get_config(args.arch)
    n_heads = max(4, args.d_model // 64)
    group = max(base.n_heads // max(base.n_kv_heads, 1), 1)
    cfg = base.replace(
        n_layers=args.layers, d_model=args.d_model, n_heads=n_heads,
        n_kv_heads=max(1, n_heads // group), head_dim=64,
        d_ff=args.d_model * 4, vocab_size=args.vocab,
        param_dtype="float32", compute_dtype="float32",
        attn_impl="chunked", padded_vocab=0, padded_heads=0,
        padded_kv_heads=0)
    if cfg.n_experts:
        cfg = cfg.replace(n_experts=8, top_k=2, expert_d_ff=args.d_model,
                          shared_d_ff=args.d_model,
                          first_k_dense=min(cfg.first_k_dense, 1))
    if cfg.ssm_state:
        cfg = cfg.replace(ssm_state=64, ssm_headdim=64, ssm_chunk=64)

    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    dc = DataConfig(batch=args.batch, seq_len=args.seq, seed=0)
    chain = ChainConfig(ckpt_dir=args.ckpt_dir, ckpt_every=100)
    trainer = ChainedTrainer(cfg, ocfg, chain,
                             data_iterator(cfg, dc, device=dev), seed=0,
                             num_microbatches=args.microbatches, device=dev)
    n = transformer.param_count(trainer.params)
    print(f"arch={args.arch} scaled config: {n/1e6:.1f}M params, "
          f"{args.steps} steps, batch {args.batch}x{args.seq}")
    resumed = trainer.maybe_resume()
    start = trainer.step
    if resumed:
        print(f"resumed from step {trainer.step}")
        trainer.data_iter = data_iterator(cfg, dc, start_step=trainer.step,
                                          device=dev)
    t0 = time.time()
    info = trainer.run_subjob(args.steps)
    losses = info["losses"]
    dt = time.time() - t0
    toks = args.batch * args.seq * len(losses)
    print(f"done: {info['steps_done']} steps ({info['reason']}), "
          f"{dt:.1f}s, {toks/dt:.0f} tok/s, stragglers={info['stragglers']}")
    k = max(len(losses) // 10, 1)
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    print(f"loss: first10={first:.3f} last10={last:.3f} "
          f"(uniform={np.log(args.vocab):.3f})")
    assert last < first, "loss did not improve"
    return dict(info, arch=cfg.arch_id, device=str(dev), params=n,
                resumed=resumed, start_step=start, first10=first,
                last10=last, uniform=float(np.log(args.vocab)),
                tokens_per_s=toks / dt)


if __name__ == "__main__":
    main()
