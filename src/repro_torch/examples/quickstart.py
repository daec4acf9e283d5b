"""Quickstart: the two planes of this framework in ~60 seconds (port of
``examples/quickstart.py``).

1. control plane — synthesize a cluster trace, replay it through the Slurm
   simulator, and let two provisioning policies (reactive vs avg) chain a
   48h sub-job pair;
2. data plane — pick an architecture (--arch), build its reduced config,
   and run a few training steps on the card (``--device cpu`` for the CPU).

Usage:
  PYTHONPATH=src python -m repro_torch.examples.quickstart \
      [--arch tinyllama-1.1b] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional


def control_plane_demo() -> Dict:
    from repro_torch.core import (ReplayCheckpointCache, build_policy,
                                  evaluate_batch)
    from repro_torch.sim import get_scenario, trace_stats

    print("=== control plane: Mirage provisioning on a V100-like cluster ===")
    # scenarios name the §6 evaluation grid: cluster / load level / chain
    sc = get_scenario("V100", "heavy", "single")
    jobs = sc.make_trace(months=1, seed=0)
    stats = {k: round(v, 2) for k, v in trace_stats(jobs).items()}
    print(f"scenario {sc.name}:", stats)
    # one checkpoint cache shares the background replay across policies
    cache = ReplayCheckpointCache(jobs, sc.profile.n_nodes)
    env = sc.make_env(trace=jobs, seed=0, history=24, interval=1800.0,
                      cache=cache)
    venv = sc.make_vector_env(4, trace=jobs, seed=0, history=24,
                              interval=1800.0, cache=cache)
    summaries = {}
    for method in ("reactive", "avg"):
        pol = build_policy(method, env)      # every method is a Policy:
        res = evaluate_batch(venv, pol, seed=1)   # 4 episodes in lockstep
        summaries[method] = res.summary()
        print(f"{method:9s} -> {summaries[method]}")
    return {"scenario": sc.name, "trace_stats": stats,
            "summaries": summaries}


def data_plane_demo(arch: str, device=None) -> Dict:
    import torch
    from repro_torch.data import DataConfig, data_iterator
    from repro_torch.device import resolve_device
    from repro_torch.models import registry, transformer
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   make_train_step)

    dev = resolve_device(device)
    print(f"=== data plane: {arch} (reduced config) ===")
    cfg = registry.get_config(arch, smoke=True)
    params = transformer.init(torch.Generator(device=dev).manual_seed(0), cfg)
    n = transformer.param_count(params)
    print(f"params: {n:,}")
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=5, total_steps=100)
    opt = init_opt_state(params, ocfg)
    step = make_train_step(cfg, ocfg)
    it = data_iterator(cfg, DataConfig(batch=8, seq_len=64), device=dev)
    t0 = time.time()
    losses = []
    for i in range(20):
        params, opt, metrics = step(params, opt, next(it))
        losses.append(float(metrics["loss"]))
        if i % 5 == 0:
            print(f"step {i:3d} loss={losses[-1]:.3f} "
                  f"({time.time()-t0:.1f}s)")
    print(f"final loss={losses[-1]:.3f}")
    return {"arch": cfg.arch_id, "device": str(dev), "params": n,
            "losses": losses}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)     # no card: raise before any work
    return {"control_plane": control_plane_demo(),
            "data_plane": data_plane_demo(args.arch, dev)}


if __name__ == "__main__":
    main()
