"""Training launcher: the entrypoint a Mirage-provisioned sub-job runs
(port of ``repro.launch.train``).

The loop is the chained-sub-job protocol: resume from the newest
checkpoint, train until the wall-clock guard (or step budget) fires,
checkpoint, exit 0 — the successor sub-job (already queued by the
provisioner) picks it up. It runs on one CUDA card unless ``--device cpu``
is given; ``--arch`` names an architecture the port carries.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \
      --steps 100 --wall-limit 3600 --ckpt-dir checkpoints/svc [--smoke] \
      [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--max-steps", type=int, default=10**9)
    ap.add_argument("--wall-limit", type=float, default=None)
    ap.add_argument("--ckpt-dir", default="checkpoints/train")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host training (not ported)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.distributed:
        raise NotImplementedError(
            "--distributed needs the port's dist/ layer (ROADMAP §1 item 5), "
            "which does not exist yet")

    from repro_torch.data import DataConfig, data_iterator
    from repro_torch.device import resolve_device
    from repro_torch.models import registry, transformer
    from repro_torch.train import ChainConfig, ChainedTrainer, OptimizerConfig

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=20,
                           total_steps=args.max_steps)
    chain = ChainConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        wall_limit_s=args.wall_limit, max_steps=args.max_steps)
    dc = DataConfig(batch=args.batch, seq_len=args.seq)
    trainer = ChainedTrainer(cfg, ocfg, chain,
                             data_iterator(cfg, dc, device=dev),
                             num_microbatches=args.microbatches, device=dev)
    resumed = trainer.maybe_resume()
    if resumed:
        print(f"[train] resumed at step {trainer.step}")
        trainer.data_iter = data_iterator(cfg, dc, start_step=trainer.step,
                                          device=dev)
    n = transformer.param_count(trainer.params)
    print(f"[train] arch={args.arch} params={n:,} target_steps={args.steps}")
    info = trainer.run_subjob(args.steps)
    print(f"[train] exit: {info['reason']} at step {info['steps_done']} "
          f"(stragglers flagged: {info['stragglers']})")
    return dict(info, arch=cfg.arch_id, device=str(dev), params=n,
                resumed=resumed)


if __name__ == "__main__":
    main()
