"""Provisioner launcher: train and evaluate a Mirage agent on a cluster
(port of ``repro.launch.provision``).

  PYTHONPATH=src python -m repro_torch.launch.provision \
      --cluster V100 --method moe+dqn --load 1.0 --episodes 10 \
      [--save-agent checkpoints/agent] [--device cpu]

Runs the paper's full §4.9 procedure on a freshly synthesized (seeded)
trace: offline sample collection -> foundation pretraining -> online RL ->
validation-split evaluation against the reactive baseline. The learners
run on CUDA unless ``--device cpu`` is given.

Robustness flags: ``--fault faulty`` threads the named fault profile's
deterministic FaultPlan (node failures + transient control errors)
through every simulator, and ``--chain-links N --journal PATH`` runs the
trained policy through the self-healing ChainDriver — retried submits,
reactive fallback on policy failure, and a crash-safe decision journal
(rerunning with the same journal resumes instead of restarting).
``--service N`` instead serves N tenant chains through the always-on
``ProvisionService`` (dynamic batching, circuit-breaker degradation,
load shedding; ``--journal DIR`` makes restarts crash-consistent).
``--save-agent DIR`` writes ``{"params": ...}`` in the JAX package's
layout (``convert.to_jax``), so either package's ``restore_checkpoint``
reads it.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster", default="V100", choices=["V100", "RTX", "A100"])
    ap.add_argument("--method", default="moe+dqn")
    ap.add_argument("--load", type=float, default=1.0)
    ap.add_argument("--months", type=int, default=1)
    ap.add_argument("--episodes", type=int, default=8)
    ap.add_argument("--online-episodes", type=int, default=8)
    ap.add_argument("--offline-episodes", type=int, default=4)
    ap.add_argument("--pretrain-epochs", type=int, default=6)
    ap.add_argument("--history", type=int, default=24)
    ap.add_argument("--interval", type=float, default=1800.0)
    ap.add_argument("--nodes", type=int, default=1, help="chain job size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-agent", default=None)
    ap.add_argument("--fault", default="",
                    help="fault profile name ('' = fault-free)")
    ap.add_argument("--chain-links", type=int, default=0,
                    help="also drive an N-link chain through ChainDriver")
    ap.add_argument("--journal", default=None,
                    help="decision-journal path for the chain driver; with "
                         "--service, the per-tenant journal directory")
    ap.add_argument("--service", type=int, default=0, metavar="N",
                    help="run the trained policy as an N-tenant "
                         "ProvisionService (overload protection + "
                         "crash-consistent recovery); uses --chain-links "
                         "links per tenant (default 2)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from repro_torch.core import (ChainDriver, DecisionJournal, EnvConfig,
                                  ProvisionEnv, ReplayCheckpointCache,
                                  build_policy, evaluate_batch)
    from repro_torch.core.provisioner import collect_offline_samples
    from repro_torch.device import resolve_device
    from repro_torch.sim import get_fault_spec, synthesize_trace
    from repro_torch.sim.scenarios import make_vector_env
    from repro_torch.sim.trace import PROFILES

    dev = resolve_device(args.device)
    profile = PROFILES[args.cluster]
    jobs = synthesize_trace(profile, months=args.months, seed=args.seed,
                            load_scale=args.load)
    spec = get_fault_spec(args.fault)
    faults = None
    if spec is not None:
        horizon = jobs[-1].submit_time + 3 * 24 * 3600.0
        faults = spec.make_plan(horizon, profile.n_nodes, args.seed)
        print(f"[provision] fault profile {args.fault}: "
              f"{len(faults) // 2} failure windows, "
              f"ctrl error rate {faults.ctrl_error_rate}")
    ecfg = EnvConfig(n_nodes=profile.n_nodes, history=args.history,
                     interval=args.interval, chain_nodes=args.nodes,
                     faults=faults)
    cache = ReplayCheckpointCache(jobs, profile.n_nodes, faults=faults)
    env_train = ProvisionEnv(jobs, ecfg, seed=args.seed, cache=cache)

    t0 = time.time()
    samples = None
    if args.method not in ("reactive", "avg"):
        samples = collect_offline_samples(env_train,
                                          n_episodes=args.offline_episodes,
                                          n_points=5, seed=args.seed)
        print(f"[provision] {len(samples)} offline samples "
              f"({time.time()-t0:.0f}s)")
    policy = build_policy(args.method, env_train, offline_samples=samples,
                          online_episodes=args.online_episodes,
                          pretrain_epochs=args.pretrain_epochs,
                          history=args.history, reduced=True, seed=args.seed,
                          device=dev)
    print(f"[provision] trained {args.method} ({time.time()-t0:.0f}s)")

    venv = make_vector_env(jobs, ecfg, args.episodes, seed=args.seed,
                           cache=cache)
    res = evaluate_batch(venv, policy, seed=args.seed + 1)
    base = evaluate_batch(venv, build_policy("reactive", env_train),
                          seed=args.seed + 1)
    out = {"method": res.summary(), "reactive": base.summary(),
           "policy": policy}
    red = (base.mean_interruption_h - res.mean_interruption_h) \
        / max(base.mean_interruption_h, 1e-9) * 100
    print(f"[provision] {args.method}: {json.dumps(res.summary())}")
    print(f"[provision] reactive: {json.dumps(base.summary())}")
    print(f"[provision] interruption reduction vs reactive: {red:.0f}%")

    if args.service > 0:
        from repro_torch.serve import ProvisionService, ServiceConfig
        svc = ServiceConfig(tenants=args.service,
                            links=args.chain_links or 2)
        service = ProvisionService(jobs, ecfg, policy, svc=svc,
                                   seed=args.seed, journal_dir=args.journal,
                                   cache=cache)
        sres = service.run()
        h = service.health()
        print(f"[provision] service ({svc.tenants} tenants x {svc.links} "
              f"links): {sres.reason}; decisions {sres.n_decisions} "
              f"({sres.n_replayed} replayed, {sres.n_degraded} degraded, "
              f"{sres.n_shed} shed) in {sres.n_rounds} rounds / "
              f"{sres.n_batches} batches; p99 latency "
              f"{sres.p99_latency_s * 1e3:.2f}ms; breaker "
              f"{h.breaker_state} ({sres.breaker_trips} trips)")
        for i, t in enumerate(sres.tenants):
            print(f"[provision]   tenant {i}: {t.reason}, interruption "
                  f"{t.interruption_h:.2f}h, overlap {t.overlap_h:.2f}h, "
                  f"{t.n_decisions} decisions ({t.n_fallbacks} fallbacks), "
                  f"ctrl errors {t.n_ctrl_errors}")
        out["service"] = sres
    elif args.chain_links > 0:
        journal = DecisionJournal(args.journal) if args.journal else None
        driver = ChainDriver(jobs, ecfg, policy, links=args.chain_links,
                             seed=args.seed, journal=journal, cache=cache)
        cres = driver.run()
        print(f"[provision] chain driver ({args.chain_links} links): "
              f"{cres.reason}, interruption {cres.interruption_h:.2f}h, "
              f"overlap {cres.overlap_h:.2f}h; decisions "
              f"{cres.n_decisions} ({cres.n_replayed} replayed, "
              f"{cres.n_fallbacks} fallbacks), ctrl errors "
              f"{cres.n_ctrl_errors} ({cres.n_retries} retries), "
              f"faults {cres.n_faults}, requeues {cres.n_requeues}")
        out["chain"] = cres

    learner = getattr(policy, "learner", None)
    if args.save_agent and learner is not None:
        from repro_torch.convert import to_jax
        from repro_torch.train.checkpoint import save_checkpoint
        save_checkpoint(args.save_agent, 0,
                        {"params": to_jax(learner.params)})
        print(f"[provision] agent saved to {args.save_agent}")
    return out


if __name__ == "__main__":
    main()
