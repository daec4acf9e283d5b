"""The paper's scenario end-to-end (port of
``examples/provision_service.py``): a long-running training service
chained through a busy batch cluster with Mirage deciding successor
submissions.

Timeline (all simulated except the payload training, which really runs,
on the card unless ``--device cpu`` is given):
  1. pick a scenario from the registry (V100 / heavy / single-node chain),
     synthesize its trace, and train Mirage's provisioner (offline
     pretraining + online DQN) as a torch learner;
  2. the service = a chain of sub-jobs; each simulated sub-job interval
     runs REAL payload training steps through ``ChainedTrainer``'s donated
     step and checkpoints (zlib-compressed ``repro_torch._msgpack``);
  3. at each 10-min tick the agent decides submit / no-submit for the
     successor via the Policy protocol's scalar ``act`` adapter; on the
     predecessor's limit the payload checkpoints and the successor resumes
     from that checkpoint;
  4. close with a batched sweep: ``evaluate_batch`` runs the method and the
     reactive baseline over lockstep episode lanes sharing one
     ReplayCheckpointCache, reporting interruption reduction.

Usage: PYTHONPATH=src python -m repro_torch.examples.provision_service \
    [--episodes 3] [--device cpu]
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=3)
    ap.add_argument("--eval-lanes", type=int, default=6,
                    help="lockstep lanes in the closing evaluate_batch sweep")
    ap.add_argument("--method", default="moe+dqn",
                    choices=["moe+dqn", "transformer+dqn", "transformer+pg",
                             "avg", "reactive", "random_forest", "xgboost"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.core import (ReplayCheckpointCache, build_policy,
                                  evaluate_batch)
    from repro_torch.core.provisioner import collect_offline_samples
    from repro_torch.data import DataConfig, data_iterator
    from repro_torch.device import resolve_device
    from repro_torch.models import registry
    from repro_torch.sim import get_scenario
    from repro_torch.train import ChainConfig, ChainedTrainer, OptimizerConfig

    dev = resolve_device(args.device)
    print("=== Mirage-provisioned training service ===")
    sc = get_scenario("V100", "heavy", "single")
    jobs = sc.make_trace(months=1, seed=42)
    cache = ReplayCheckpointCache(jobs, sc.profile.n_nodes)
    env = sc.make_env(trace=jobs, seed=0, history=24, interval=1800.0,
                      cache=cache)

    t0 = time.time()
    samples = collect_offline_samples(env, n_episodes=4, n_points=5, seed=1)
    print(f"offline samples: {len(samples)} ({time.time()-t0:.0f}s)")
    policy = build_policy(args.method, env, offline_samples=samples,
                          online_episodes=6, pretrain_epochs=5,
                          history=24, reduced=True, seed=0, device=dev)
    reactive = build_policy("reactive", env)
    print(f"trained {args.method} on {sc.name} ({time.time()-t0:.0f}s)")

    # payload: real training chained across the provisioned sub-jobs
    cfg = registry.get_config("tinyllama-1.1b", smoke=True)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=10_000)
    ckpt_dir = tempfile.mkdtemp(prefix="mirage_service_")
    dc = DataConfig(batch=4, seq_len=32)

    total_steps, lost, subjobs = 0, 0, []
    for ep in range(args.episodes):
        obs = env.reset(t_start=None)
        # sub-job J_k trains while its simulated job "runs"
        trainer = ChainedTrainer(
            cfg, ocfg, ChainConfig(ckpt_dir=ckpt_dir, ckpt_every=10),
            data_iterator(cfg, dc, start_step=total_steps, device=dev),
            seed=ep, device=dev)
        trainer.maybe_resume()
        # steps the predecessors trained that this successor does not hold
        lost += total_steps - trainer.step
        info = trainer.run_subjob(10)
        total_steps = info["steps_done"]
        done, outcome = False, {}
        while not done:
            a = policy.act(obs)        # Policy protocol's scalar adapter
            obs, r, done, outcome = env.step(a)
        print(f"  ep{ep} payload@step {total_steps}: "
              f"{outcome['kind']} {outcome['amount_s']/3600:.1f}h "
              f"(wait {outcome['wait_s']/3600:.1f}h)")
        subjobs.append({"payload_step": total_steps, "kind": outcome["kind"],
                        "amount_h": outcome["amount_s"] / 3600,
                        "wait_h": outcome["wait_s"] / 3600,
                        "losses": info["losses"]})

    # batched sweep off the same warm cache: method vs reactive baseline
    venv = sc.make_vector_env(args.eval_lanes, trace=jobs, seed=0,
                              history=24, interval=1800.0, cache=cache)
    res = evaluate_batch(venv, policy, seed=7)
    base = evaluate_batch(venv, reactive, seed=7)
    mi, mr = res.mean_interruption_h, base.mean_interruption_h
    reduction = 100 * (mr - mi) / max(mr, 1e-9)
    print(f"[{args.eval_lanes}-lane sweep] mean interruption: "
          f"{args.method}={mi:.1f}h reactive={mr:.1f}h "
          f"(reduction {reduction:.0f}%)")
    print(f"payload training steps preserved across sub-jobs: {total_steps} "
          f"({lost} lost — successor resumed from checkpoint each time)")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"method": args.method, "device": str(dev),
            "offline_samples": len(samples), "subjobs": subjobs,
            "total_steps": total_steps, "lost_steps": lost,
            "summary": res.summary(), "reactive_summary": base.summary(),
            "reduction_pct": reduction}


if __name__ == "__main__":
    main()
