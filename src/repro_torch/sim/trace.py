"""Job traces: schema, synthetic generation calibrated to the paper's
published statistics, and the §3.2 data-cleaning pipeline.

The TACC traces themselves are not redistributable; ``synthesize_trace``
generates seeded traces matching every statistic the paper reports
(Table 1 + §3.1): node counts, per-month job volume, node-count mixture
with heavy-tailed multi-node node-hour share, runtime/limit distributions
(including RTX's large population of <30s jobs), bursty arrivals with
diurnal/weekly modulation, and load regimes that reproduce the paper's
queue-wait bands. See DESIGN §2.1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

HOUR = 3600.0
DAY = 24 * HOUR


@dataclasses.dataclass
class Job:
    job_id: int
    user_id: int
    submit_time: float
    runtime: float            # actual execution time (seconds)
    time_limit: float         # requested wall-clock limit (seconds)
    n_nodes: int
    job_name: str = ""
    # filled by the simulator
    start_time: float = -1.0
    end_time: float = -1.0

    @property
    def wait_time(self) -> float:
        return self.start_time - self.submit_time if self.start_time >= 0 else -1.0


@dataclasses.dataclass(frozen=True)
class ClusterProfile:
    """Calibration targets for one of the paper's clusters (§3.1)."""
    name: str
    n_nodes: int
    jobs_per_month: float
    jobs_per_month_std: float
    mean_nodes: float          # average nodes/job
    short_job_frac: float      # <30s jobs (RTX noise population)
    multi_node_frac: float     # fraction of multi-node jobs
    max_limit: float = 48 * HOUR
    months: int = 20


# Table 1 / §3.1 calibration
V100 = ClusterProfile("V100", 88, 2955, 1289, 2.5, 0.05, 0.25)
RTX = ClusterProfile("RTX", 84, 8378, 2017, 1.3, 0.55, 0.10)
A100 = ClusterProfile("A100", 76, 4377, 659, 1.6, 0.03, 0.15, months=5)
PROFILES = {"V100": V100, "RTX": RTX, "A100": A100}


def synthesize_trace(profile: ClusterProfile, months: Optional[int] = None,
                     seed: int = 0, load_scale: float = 1.0,
                     include_noise: bool = False) -> List[Job]:
    """Generate a seeded synthetic trace for a cluster profile.

    load_scale scales job volume/runtimes to move the cluster between the
    paper's light / medium / heavy load regimes. With include_noise=True
    the raw pathologies of §3.2 (oversized requests, sub-job arrays) are
    injected so clean_trace() has something to clean.
    """
    rng = np.random.default_rng(seed)
    months = months or profile.months
    horizon = months * 30 * DAY
    n_jobs = int(profile.jobs_per_month * months * load_scale)

    # --- arrivals: bursty (Pareto inter-arrival) + diurnal/weekly pattern ---
    raw_gaps = rng.pareto(1.5, n_jobs) + 0.05
    t = np.cumsum(raw_gaps)
    t = t / t[-1] * horizon
    # diurnal modulation: compress arrivals into working hours
    frac_day = (t % DAY) / DAY
    shift = 0.25 * np.sin(2 * np.pi * (frac_day - 0.3)) * HOUR * 4
    weekday = ((t // DAY) % 7) < 5
    t = np.clip(t + shift * weekday, 0, horizon)
    t.sort()

    # --- node counts: 1 dominates; heavy tail for multi-node -----------------
    n_nodes = np.ones(n_jobs, dtype=np.int64)
    multi = rng.random(n_jobs) < profile.multi_node_frac
    tail = np.minimum(
        rng.zipf(1.6, multi.sum()) + 1, profile.n_nodes)
    n_nodes[multi] = tail
    # calibrate the mean (only boost if still short of the target)
    if n_nodes.mean() < profile.mean_nodes:
        boost = rng.random(n_jobs) < 0.03
        n_nodes[boost] = np.minimum(
            n_nodes[boost] * rng.integers(2, 8, boost.sum()),
            profile.n_nodes // 2)

    # --- runtimes: mixture of short noise, medium, and limit-length jobs -----
    runtimes = np.empty(n_jobs)
    u = rng.random(n_jobs)
    short = u < profile.short_job_frac
    runtimes[short] = rng.uniform(1, 30, short.sum())
    med = (~short) & (u < profile.short_job_frac + 0.70)
    runtimes[med] = rng.lognormal(np.log(2 * HOUR), 1.2, med.sum())
    longm = ~(short | med)
    runtimes[longm] = rng.uniform(12 * HOUR, profile.max_limit, longm.sum())
    runtimes = np.clip(runtimes, 1.0, profile.max_limit)

    # --- normalize offered load -------------------------------------------
    # load_scale is the OFFERED LOAD (node-hours demanded / capacity):
    # ~0.5 light, ~0.85 medium, >=1.0 heavy (the paper's wait-time bands).
    # The <30s noise population is excluded from rescaling (it must stay
    # short — it is an RTX trace signature, §3.1 — and carries ~0 load).
    demand = float((n_nodes[~short] * runtimes[~short]).sum())
    capacity = profile.n_nodes * horizon
    runtimes[~short] = np.clip(
        runtimes[~short] * (capacity / demand) * load_scale,
        30.0, profile.max_limit)

    # --- limits: padded runtimes, quantized to common values -----------------
    common = np.array([0.5, 1, 2, 4, 8, 12, 24, 48]) * HOUR
    lim_idx = np.searchsorted(common, runtimes * rng.uniform(1.1, 3.0, n_jobs))
    limits = common[np.minimum(lim_idx, len(common) - 1)]
    limits = np.maximum(limits, runtimes)

    users = rng.zipf(1.8, n_jobs) % 200

    jobs = [Job(job_id=i + 1, user_id=int(users[i]), submit_time=float(t[i]),
                runtime=float(runtimes[i]), time_limit=float(limits[i]),
                n_nodes=int(n_nodes[i]), job_name=f"job_{i+1}")
            for i in range(n_jobs)]

    if include_noise:
        jobs = _inject_noise(jobs, profile, rng)
    return jobs


def _inject_noise(jobs: List[Job], profile: ClusterProfile, rng) -> List[Job]:
    """Inject the §3.2 pathologies: oversized requests + sub-job arrays."""
    noisy = list(jobs)
    n = len(jobs)
    # 1) early jobs requesting more nodes than the partition has
    for i in range(max(3, n // 200)):
        j = jobs[rng.integers(0, max(1, n // 10))]
        noisy.append(Job(job_id=100_000 + i, user_id=j.user_id,
                         submit_time=j.submit_time + 1.0,
                         runtime=j.runtime, time_limit=j.time_limit,
                         n_nodes=profile.n_nodes + int(rng.integers(1, 64)),
                         job_name=f"oversized_{i}"))
    # 2) sub-jobs recorded separately with a shared name prefix
    for i in range(max(3, n // 100)):
        j = jobs[rng.integers(0, n)]
        parts = int(rng.integers(2, 5))
        for k in range(parts):
            noisy.append(Job(job_id=200_000 + i * 10 + k, user_id=j.user_id,
                             submit_time=j.submit_time + k * j.runtime / parts,
                             runtime=j.runtime / parts,
                             time_limit=j.time_limit,
                             n_nodes=j.n_nodes,
                             job_name=f"array_{i}.sub_{k}"))
    noisy.sort(key=lambda x: x.submit_time)
    return noisy


def clean_trace(jobs: Sequence[Job], n_nodes_available: int) -> List[Job]:
    """§3.2 data cleaning:
    1) drop jobs requesting more nodes than the partition has;
    2) merge sub-jobs sharing a name prefix into one job spanning
       first-start..last-end;
    3) maintenance gaps are simply absent arrivals (nothing to do).
    """
    kept = [j for j in jobs if j.n_nodes <= n_nodes_available]
    groups: Dict[Tuple[int, str], List[Job]] = {}
    singles: List[Job] = []
    for j in kept:
        if ".sub_" in j.job_name:
            prefix = j.job_name.split(".sub_")[0]
            groups.setdefault((j.user_id, prefix), []).append(j)
        else:
            singles.append(j)
    for (_, prefix), subs in groups.items():
        subs.sort(key=lambda x: x.submit_time)
        first, last = subs[0], subs[-1]
        total_rt = (last.submit_time + last.runtime) - first.submit_time
        singles.append(Job(
            job_id=first.job_id, user_id=first.user_id,
            submit_time=first.submit_time, runtime=total_rt,
            time_limit=max(s.time_limit for s in subs),
            n_nodes=first.n_nodes, job_name=prefix))
    singles.sort(key=lambda x: x.submit_time)
    return singles


def split_trace(jobs: Sequence[Job], train_frac: float = 0.8
                ) -> Tuple[List[Job], List[Job]]:
    """Temporal 80:20 train/validation split (§6)."""
    if not jobs:
        return [], []
    t0 = jobs[0].submit_time
    t1 = jobs[-1].submit_time
    cut = t0 + train_frac * (t1 - t0)
    train = [j for j in jobs if j.submit_time <= cut]
    val = [j for j in jobs if j.submit_time > cut]
    return train, val


def trace_stats(jobs: Sequence[Job]) -> Dict[str, float]:
    if not jobs:
        return {}
    nodes = np.array([j.n_nodes for j in jobs], float)
    rts = np.array([j.runtime for j in jobs], float)
    months = max((jobs[-1].submit_time - jobs[0].submit_time) / (30 * DAY), 1e-9)
    nh = nodes * rts / HOUR
    multi = nodes > 1
    return {
        "n_jobs": len(jobs),
        "jobs_per_month": len(jobs) / months,
        "mean_nodes": float(nodes.mean()),
        "short_frac": float((rts < 30).mean()),
        "multi_node_frac": float(multi.mean()),
        "multi_node_hour_share": float(nh[multi].sum() / max(nh.sum(), 1e-9)),
        "mean_runtime_h": float(rts.mean() / HOUR),
    }
