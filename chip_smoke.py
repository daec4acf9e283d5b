#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of Mirage's serving path on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

1. card and build: the card's name and power limit, and the nvcc build of
   every kernel in ``src/repro_torch/csrc`` (one nvcc per source, in
   parallel);
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes and at ragged ones, with the tolerance stated;
3. serving at the agent's full published width: ``evaluate_batch`` over 32
   lockstep episodes of ``V100/medium/single`` at history 144, for
   ``moe+dqn`` (Mirage's default), ``transformer+dqn`` and ``reactive``,
   with the kernels' launch counts checked against decisions x layers x
   launches per layer, the Q-values of the kernel path held against the
   plain path on the CPU, and each learner's decision batch on the first
   observation under torch.profiler (device-busy share, device time per
   kernel);
4. each kernel's time at the serving path's shapes beside its plain
   version, the PyTorch library call that computes the same function, and
   the least time the card could take (its bound).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import mirage_agent  # noqa: E402
from repro_torch.convert import tree_map  # noqa: E402
from repro_torch.core import (DQNConfig, DQNLearner,  # noqa: E402
                              FoundationConfig, LearnerPolicy, Policy,
                              ReactivePolicy, evaluate_batch, q_values)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.moe_gemm import (grouped_gemm,  # noqa: E402
                                          grouped_gemm_ref)
from repro_torch.sim import get_scenario, make_vector_env  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and
# bf16 tensor-core FLOP/s; the bound of a kernel is the larger of its bytes
# over the first and its operations over the second
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

LANES = 32                                  # lockstep episodes per chunk
HISTORY = 144
TRUNK = mirage_agent.CONFIG
GEMMS_PER_LAYER = 6                         # q, k, v, o, ffn in, ffn out
FLASH_PER_LAYER = 1
BF16_TOL = 2e-2      # bf16 rounds once at the output; two summation orders
                     # may land one bf16 ulp (2^-7 relative) apart
FP32_FLASH_TOL = 3e-5   # the repo's bound for the Pallas kernel in fp32
FP32_GEMM_TOL = 1e-5    # fp32 sums of 41 terms in two orders
PROFILE_STEPS = 5       # decision batches under torch.profiler


def line(tag: str, **kw) -> None:
    print(f"[{tag}] " + json.dumps(kw, default=float), flush=True)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ------------------------------------------------------------ 1. build
def phase_build() -> None:
    print(card(), flush=True)
    t0 = time.perf_counter()
    logs = _build.build(_build.SIGNATURES)
    usage = {n: [ln.strip() for ln in log.splitlines() if "Used" in ln]
             for n, log in logs.items()}
    line("build", seconds=time.perf_counter() - t0, built=sorted(logs),
         ptxas=usage)


# ------------------------------------------------------ 2. kernel checks
def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def flash_inputs(gen, B, Sq, Skv, Hq, Hkv, D, dtype):
    return (_randn(gen, (B, Sq, Hq, D), dtype), _randn(gen, (B, Skv, Hkv, D), dtype),
            _randn(gen, (B, Skv, Hkv, D), dtype))


def gemm_inputs(gen, E, C, d, f, dtype):
    return (_randn(gen, (E, C, d), dtype),
            _randn(gen, (E, d, f), dtype, 1.0 / d ** 0.5))


def _err(out, ref, atol, rtol, what):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol, msg=lambda m:
                               f"{what}: kernel disagrees with plain: {m}")
    return err


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    B = 2 * LANES * mirage_agent.N_EXPERTS
    errs = {}
    cases = [
        ("flash agent (640,144,8,32) bf16", dict(causal=False),
         (B, HISTORY, HISTORY, 8, 8, 32, torch.bfloat16), BF16_TOL, BF16_TOL),
        ("flash causal GQA window softcap (2,97|131,8/2,64) fp32",
         dict(causal=True, window=40, softcap=30.0),
         (2, 97, 131, 8, 2, 64, torch.float32), FP32_FLASH_TOL, 0.0),
        ("flash causal (1,200,4,128) bf16", dict(causal=True),
         (1, 200, 200, 4, 4, 128, torch.bfloat16), BF16_TOL, BF16_TOL),
    ]
    for name, opts, shape, atol, rtol in cases:
        q, k, v = flash_inputs(gen, *shape)
        out = flash_attention(q, k, v, **opts)
        torch.cuda.synchronize()
        err = _err(out, flash_attention_ref(q, k, v, **opts), atol, rtol, name)
        errs["flash_attention"] = max(errs.get("flash_attention", 0.0), err)
        line("check", case=name, max_abs_err=err, atol=atol, rtol=rtol)
    # every projection shape of the trunk (q, k, v, o; ffn in; ffn out)
    E, C = mirage_agent.N_EXPERTS, 2 * LANES * HISTORY
    d, f = TRUNK.d_model, TRUNK.d_ff
    cases = [(f"gemm ({E},{C},{a})x({E},{a},{b}) bf16",
              (E, C, a, b, torch.bfloat16), BF16_TOL, BF16_TOL)
             for a, b in ((d, d), (d, f), (f, d))]
    cases.append(("gemm (10,300,41)x(10,41,256) fp32",
                  (10, 300, 41, 256, torch.float32), FP32_GEMM_TOL,
                  FP32_GEMM_TOL))
    for name, shape, atol, rtol in cases:
        x, w = gemm_inputs(gen, *shape)
        out = grouped_gemm(x, w)
        torch.cuda.synchronize()
        err = _err(out, grouped_gemm_ref(x, w), atol, rtol, name)
        errs["grouped_gemm"] = max(errs.get("grouped_gemm", 0.0), err)
        line("check", case=name, max_abs_err=err, atol=atol, rtol=rtol)
        del x, w, out
    return errs


# ------------------------------------------------------------ 3. serving
class TimedPolicy(Policy):
    """Counts decision batches and times each one on the host clock (the
    learner's ``act_batch`` returns numpy, so it waits for the card)."""

    def __init__(self, inner):
        self.inner, self.method = inner, inner.method
        self.ms = []
        self.first_states = None

    def act_batch(self, obs):
        if self.first_states is None:
            self.first_states = np.array(obs["matrix"], np.float32)
        t0 = time.perf_counter()
        acts = self.inner.act_batch(obs)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return acts


def serve(venv, name, policy, kernel_path: bool):
    timed = TimedPolicy(policy)
    flash_attention.launches = grouped_gemm.launches = 0
    t0 = time.perf_counter()
    res = evaluate_batch(venv, timed, seed=1)
    wall = time.perf_counter() - t0
    flash, gemm = flash_attention.launches, grouped_gemm.launches
    decisions = len(timed.ms)
    layers = TRUNK.n_layers if kernel_path else 0
    if (kernel_path and not flash) or \
            flash != decisions * layers * FLASH_PER_LAYER or \
            gemm != decisions * layers * GEMMS_PER_LAYER:
        raise RuntimeError(f"{name}: {flash} flash and {gemm} GEMM launches "
                           f"for {decisions} decision batches")
    summary = res.summary()
    if summary["n_episodes"] != LANES:
        raise RuntimeError(f"{name}: {summary['n_episodes']} episodes")
    ms = np.asarray(timed.ms)
    line("serve", method=name, summary=summary, decision_batches=decisions,
         flash_launches=flash, gemm_launches=gemm,
         ms_per_decision_mean=float(ms.mean()),
         ms_per_decision_p50=float(np.percentile(ms, 50)),
         ms_per_decision_p99=float(np.percentile(ms, 99)),
         episodes_per_s=LANES / wall, wall_s=wall)
    return {"flash_attention": flash, "grouped_gemm": gemm}, timed.first_states


def check_q_values(learner, states: np.ndarray) -> None:
    """Q-values of the kernel path on the card against the plain path on
    the CPU, same weights, on two states the serving run decided."""
    states = torch.from_numpy(states[:2])
    with torch.inference_mode():
        q_gpu = q_values(learner.params, learner.fc, states.cuda()).cpu()
        cpu = tree_map(lambda t: t.cpu(), learner.params)
        q_cpu = q_values(cpu, learner.fc, states)
    if not torch.isfinite(q_gpu).all() or q_gpu.shape != (2, 2):
        raise RuntimeError(f"bad Q-values {q_gpu}")
    err = _err(q_gpu, q_cpu, BF16_TOL, BF16_TOL, f"{learner.fc.kind} q_values")
    line("q_values", kind=learner.fc.kind, max_abs_err=err, atol=BF16_TOL,
         q=q_gpu.tolist())


def _union_us(intervals) -> float:
    busy, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            busy += e - s
        elif e > end:
            busy += e - end
        end = max(end, e)
    return busy


def profile_decisions(learner, states: np.ndarray, steps=PROFILE_STEPS):
    """``steps`` decision batches of ``learner`` on ``states`` under
    torch.profiler, after two warm-up calls: host wall time per batch, the
    share of it the card was busy (the union of kernel intervals), and
    device time per kernel name, largest first."""
    for _ in range(2):
        learner.act_batch(states, explore=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            learner.act_batch(states, explore=False)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_name, intervals = defaultdict(lambda: [0, 0.0]), []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t_start, t_end = e.time_range.start, e.time_range.end
        intervals.append((t_start, t_end))
        per_name[e.name][0] += 1
        per_name[e.name][1] += t_end - t_start
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    kernels = sorted(per_name.items(), key=lambda kv: -kv[1][1])
    line("profile", kind=learner.fc.kind, lanes=len(states), steps=steps,
         wall_ms_per_decision=wall_us / steps / 1e3,
         device_busy_share=_union_us(intervals) / wall_us,
         device_ms_per_decision=sum(us for _, us in per_name.values())
         / steps / 1e3,
         kernels=[{"name": n[:120], "calls_per_decision": c / steps,
                   "ms_per_decision": us / steps / 1e3}
                  for n, (c, us) in kernels])


def phase_serve() -> dict:
    scn = get_scenario("V100", "medium", "single")
    trace = scn.make_trace(months=1, seed=0)
    cfg = scn.env_config(history=HISTORY, interval=600.0)
    venv = make_vector_env(trace, cfg, LANES, seed=0)
    launches = None
    for kind in ("moe", "transformer"):
        fc = FoundationConfig(kind=kind, history=HISTORY, trunk=TRUNK)
        learner = DQNLearner(fc, DQNConfig(), seed=0)
        counts, states = serve(venv, f"{kind}+dqn",
                               LearnerPolicy(f"{kind}+dqn", learner),
                               kernel_path=True)
        launches = launches or counts       # the moe+dqn run is the main path
        check_q_values(learner, states)
        profile_decisions(learner, states)
        del learner
        torch.cuda.empty_cache()
    serve(venv, "reactive", ReactivePolicy(), kernel_path=False)
    return launches


# ------------------------------------------------------------ 4. timing
def time_ms(fn, reps=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_timing(errs: dict, launches: dict) -> list:
    gen = torch.Generator(device="cuda").manual_seed(1)
    B = 2 * LANES * mirage_agent.N_EXPERTS
    H, D = TRUNK.n_heads, TRUNK.hd
    q, k, v = flash_inputs(gen, B, HISTORY, HISTORY, H, H, D, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    t = {"ms": time_ms(lambda: flash_attention(q, k, v, causal=False)),
         "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, causal=False),
                             reps=5),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=False))}
    nbytes = 4 * q.numel() * q.element_size()          # q, k, v read; o written
    flops = 4 * B * H * HISTORY * HISTORY * D          # q.k^T and p.v
    bms, by = bound_ms(nbytes, flops)
    flash_rec = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:33",
        launches=launches["flash_attention"],
        max_abs_err=errs["flash_attention"], bound_ms=bms, bound_by=by,
        shape="q,k,v (640,144,8,32) bf16, non-causal: one trunk layer", **t)
    line("time", **flash_rec)
    del q, k, v, qt, kt, vt

    # one trunk layer's six projections at E=10, C = 2 actions x 32 lanes x 144
    C, d, f = 2 * LANES * HISTORY, TRUNK.d_model, TRUNK.d_ff
    per_layer = [(d, d)] * 4 + [(d, f), (f, d)]
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    nbytes = flops = 0
    for din, dout in per_layer:
        x, w = gemm_inputs(gen, mirage_agent.N_EXPERTS, C, din, dout,
                           torch.bfloat16)
        one = {"ms": time_ms(lambda: grouped_gemm(x, w)),
               "plain_ms": time_ms(lambda: grouped_gemm_ref(x, w), reps=5),
               "library_ms": time_ms(lambda: torch.bmm(x, w))}
        b = (x.numel() + w.numel() + x.shape[0] * C * dout) * x.element_size()
        fl = 2 * x.shape[0] * C * din * dout
        line("time", name="grouped_gemm", shape=f"({x.shape[0]},{C},{din})x"
             f"({x.shape[0]},{din},{dout}) bf16", bound_ms=bound_ms(b, fl)[0],
             **one)
        for key in tot:
            tot[key] += one[key]
        nbytes, flops = nbytes + b, flops + fl
        del x, w
    bms, by = bound_ms(nbytes, flops)
    gemm_rec = dict(
        name="grouped_gemm", route="cuda", source="src/repro_torch/csrc/moe_gemm.cu",
        replaces="src/repro/kernels/moe_gemm/kernel.py:23",
        launches=launches["grouped_gemm"], max_abs_err=errs["grouped_gemm"],
        bound_ms=bms, bound_by=by,
        shape="the 6 projections of one trunk layer, E=10, C=9216, bf16", **tot)
    line("time", **gemm_rec)
    return [flash_rec, gemm_rec]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    phase_build()
    errs = phase_kernels()
    launches = phase_serve()
    records = phase_timing(errs, launches)
    print(json.dumps({"kernels": records}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
