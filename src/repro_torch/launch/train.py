"""Training launcher: the entrypoint a Mirage-provisioned sub-job runs
(port of ``repro.launch.train``).

The loop is the chained-sub-job protocol: resume from the newest
checkpoint, train until the wall-clock guard (or step budget) fires,
checkpoint, exit 0 — the successor sub-job (already queued by the
provisioner) picks it up. With ``--distributed`` the sub-job first joins
the process group torchrun describes (NCCL on CUDA, gloo on the CPU),
resumes by placing the checkpoint on ``make_host_mesh()``
(``restore_checkpoint(shardings=)``), trains as without the flag, and
leaves the group at exit. It runs on one CUDA card unless ``--device cpu``
is given; ``--arch`` names an architecture the port carries and defaults
to TinyLlama-1.1B, as in the reference (``--arch qwen2-vl-7b`` trains on
text batches with M-RoPE's (3, B, S) positions).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --steps 100 --wall-limit 3600 --ckpt-dir checkpoints/svc [--smoke] \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None,
         init_method: Optional[str] = None) -> Dict:
    """``init_method`` overrides torchrun's environment as the process
    group's rendezvous (a ``file://`` store where no socket is wanted)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
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
                    help="join torchrun's process group (NCCL on CUDA, "
                         "gloo on the CPU) and resume on its host mesh")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    mesh = None
    if args.distributed:
        import torch
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_host_mesh
        if dev.type == "cuda":          # one card a rank
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        # torchrun's environment: RANK, WORLD_SIZE, MASTER_ADDR/PORT
        kw = {} if init_method is None else dict(
            init_method=init_method, rank=int(os.environ.get("RANK", 0)),
            world_size=int(os.environ.get("WORLD_SIZE", 1)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                **kw)
        mesh = make_host_mesh(dev)
    try:
        return _subjob(args, dev, mesh)
    finally:
        if args.distributed:
            dist.destroy_process_group()


def _subjob(args, dev, mesh) -> Dict:
    from repro_torch.data import DataConfig, data_iterator
    from repro_torch.models import registry, transformer
    from repro_torch.train import ChainConfig, ChainedTrainer, OptimizerConfig

    cfg = registry.get_config(args.arch, smoke=args.smoke)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=20,
                           total_steps=args.max_steps)
    chain = ChainConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                        wall_limit_s=args.wall_limit, max_steps=args.max_steps)
    dc = DataConfig(batch=args.batch, seq_len=args.seq)
    trainer = ChainedTrainer(cfg, ocfg, chain,
                             data_iterator(cfg, dc, device=dev),
                             num_microbatches=args.microbatches, device=dev,
                             mesh=mesh)
    t0 = time.monotonic()
    resumed = trainer.maybe_resume()
    resume_s = time.monotonic() - t0
    if resumed:
        print(f"[train] resumed at step {trainer.step} ({resume_s:.1f} s)")
        trainer.data_iter = data_iterator(cfg, dc, start_step=trainer.step,
                                          device=dev)
    n = transformer.param_count(trainer.params)
    print(f"[train] arch={args.arch} params={n:,} target_steps={args.steps}")
    info = trainer.run_subjob(args.steps)
    print(f"[train] exit: {info['reason']} at step {info['steps_done']} "
          f"(stragglers flagged: {info['stragglers']}; exit checkpoint "
          f"{info['exit_ckpt_s']:.1f} s)")
    return dict(info, arch=cfg.arch_id, device=str(dev), params=n,
                resumed=resumed, resume_s=resume_s)


if __name__ == "__main__":
    main()
