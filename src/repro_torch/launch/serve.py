"""Serving launcher: the long-running inference service Mirage keeps alive
(port of ``repro.launch.serve``).

Draws seeded random weights on the device, or loads the newest checkpoint
under ``--ckpt-dir`` if one exists (the successor sub-job resumes the same
weights; the LM tree has one layout in both packages, so a checkpoint the
JAX package wrote loads too), then serves a stream of synthetic requests
(6-token prompts) through the slot-based engine until every request is
done or the wall-clock guard fires.

  PYTHONPATH=src python -m repro_torch.launch.serve [--arch tinyllama-1.1b] \
      [--smoke] [--requests 8] [--ckpt-dir checkpoints/svc] [--device cpu]

``--arch`` defaults to TinyLlama-1.1B, as in the reference; Mamba2-1.3B is
``--arch mamba2-1.3b``, the hybrid Zamba2-7B (its shared attention block
tied across 11 applications) ``--arch zamba2-7b``, and DeepSeek-V2 (MLA,
160 experts top-6) ``--arch deepseek-v2-236b`` and Command-R 35B ``--arch
command-r-35b``, whose full depths do not fit one card in fp32 (``--smoke``
serves their reduced configs); Qwen2-VL-7B ``--arch qwen2-vl-7b`` serves
its text requests under M-RoPE, the three position streams equal. ``--arch hubert-xlarge`` is refused: the
engine serves no encoder, as the reference's does not. It runs on CUDA
unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--wall-limit", type=float, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.models import registry, transformer
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import PreemptionGuard
    from repro_torch.train.checkpoint import latest_step, restore_checkpoint

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    params = transformer.init(torch.Generator(device=dev).manual_seed(0), cfg)
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        state, step = restore_checkpoint(args.ckpt_dir, {"params": params},
                                         device=dev)
        params = state["params"]
        print(f"[serve] restored weights from step {step}")

    guard = PreemptionGuard(args.wall_limit, grace_s=5.0,
                            install_signals=False)
    eng = ServeEngine(cfg, params, batch=args.batch, s_max=args.s_max,
                      device=dev)
    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(args.requests):
        prompt = [int(t) for t in rng.integers(0, cfg.vocab_size, 6)]
        reqs.append(Request(rid=rid, prompt=prompt, max_new=args.max_new))
        eng.add_request(reqs[-1])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)     # the weights are drawn
    t0 = time.perf_counter()
    served_tokens = 0
    while eng.queue or any(r is not None for r in eng.slot_req):
        if guard.should_stop():
            print("[serve] wall limit — stop and hand off")
            break
        served_tokens += eng.step()
    dt = time.perf_counter() - t0
    done = sum(r.done for r in reqs)
    print(f"[serve] {served_tokens} tokens in {dt:.1f}s "
          f"({served_tokens / max(dt, 1e-9):.1f} tok/s); "
          f"{done}/{len(reqs)} requests done")
    return {"arch": cfg.arch_id, "device": str(dev), "requests": len(reqs),
            "done": done, "tokens": served_tokens, "seconds": dt,
            "outputs": [list(r.out) for r in reqs],
            "tokens_per_s": served_tokens / max(dt, 1e-9)}


if __name__ == "__main__":
    main()
