#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA
H100.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

1. card and build: the card's name and power limit, and the nvcc build of
   every kernel in ``src/repro_torch/csrc`` (one nvcc per source, in
   parallel);
2. each kernel against its plain PyTorch version on the card, at the
   serving paths' shapes and at ragged ones, with the tolerance stated; each
   case checks through the launch counters which variant ran (flash, the
   GEMM and the SSD scan: bf16 on the tensor cores, fp32 and unaligned
   inputs on the CUDA cores; RMSNorm: 16-byte vectors, and one element per
   lane for rows off 16 bytes); the backward kernels through autograd:
   flash's (with the forward's row log-sum-exp) and the GEMM's (in bf16 both
   products from one launch of the fused kernel, dW split along C and the
   same bit for bit over repeated calls), and RMSNorm's and the SSD scan's
   at phase 8's shapes, ragged rows and chunks, chunks whose length is not
   a multiple of the scan backward's tiles (100, and the smoke config's
   16), d off 8, gemma, G = 2, P = 128, an initial state and the final
   state's gradient, fp32 and bf16, each case's variant checked through
   the counters (RMSNorm's "vec" and the scan's "tc" for bf16 they can
   address, "simt" otherwise) and, where that is the fast one, the "simt"
   variant held to the same bound on the same inputs; their reductions
   (dw; dA, dB, dC, dD) the same bit for bit over repeated calls;
3. the agent's serving path at its full published width: ``evaluate_batch``
   over 32 lockstep episodes of ``V100/medium/single`` at history 144, for
   ``moe+dqn`` (Mirage's default), ``transformer+dqn`` and ``reactive``,
   with the flash and GEMM launch counts checked against decisions x
   layers x launches per layer, every one of them on the tensor cores, the
   Q-values of the kernel path held against the plain path on the CPU, and
   each learner's decision batch on the first observation under
   torch.profiler (device-busy share, device time per kernel);
4. the payload LM's serving path, Mamba2-1.3B at its full published width
   with seeded random weights drawn on the card: ``make_prefill_step`` on
   4 prompts of 2048 tokens and 32 greedy ``make_serve_step`` decode steps
   (exact RMSNorm and SSD launch counts per prefill and per step, every
   scan on the tensor cores and every norm vectorised), the
   first 2 layers' kernel path held against the plain path on the CPU,
   ``ServeEngine`` through ``repro_torch.launch.serve`` at the CLI's
   defaults, and a prefill and 5 decode steps under torch.profiler (one
   pass each);
4b. the agent's training path at phase 3's width on its scenario, run
   after the LM phase so that phase 4 meets the card as before:
   ``collect_offline_samples``, ``pretrain_foundation`` (moe, batch 16, 4
   steps), ``train_online_dqn`` (32 episodes in rollouts of 8 lanes, replay
   batches of 32, so each ``train_on`` is a full-width step at C = 9216),
   ``train_online_pg`` (4 episodes), then the trained DQN learner serving
   one ``evaluate_batch`` chunk of 32 lanes; ms per step, the losses (all
   finite), the backward launch counts checked against steps x layers (one
   flash backward a layer, and 12 GEMM backward products from 6 fused
   calls, all on the tensor cores), one full-width
   ``train_on``'s gradients at batch 4 held against the CPU plain path, and
   a torch.profiler pass over 3 ``train_on`` steps;
6. the Fig-8 grid on torch learners at the agent's full width, as
   ``benchmarks/bench_interruption.py`` runs it at its QUICK counts: one
   cluster (V100), single-node chains, the six cells {light, medium, heavy}
   x {fault-free, faulty}, all eight methods trained on the fault-free
   heavy cell (trace seed 100; 6 online episodes, 5 pretraining epochs, 4
   offline episodes) and evaluated on 5 lanes a cell (trace seed 200,
   ``evaluate_batch`` seed 7), one ``[grid]`` line per (cell, method); then
   cross-tenant training, ``train_online_dqn`` at the full moe width over
   16 episodes in 2 co-simulation groups of 8 contending chains. It raises
   on a non-finite summary, a fallback, a flash or GEMM launch (forward or
   backward) off the tensor cores, or backward counts that are not steps x
   layers x (1 flash, 12 GEMM products);
7. ``ProvisionService`` and ``ChainDriver`` serving the grid's moe+dqn
   learner in ``benchmarks/bench_serve.py``'s world at history 144: (a) 128
   tenants x 1 link, one fork each, and again with the circuit breaker
   forced open (the loop's host-only cost); (b) 1024 tenants contending in
   one co-simulation; (c) 8 tenants x 2 links, journaled, killed by an
   uncatchable exception and restarted on its journals; (d) a 2-link
   ``ChainDriver``, journaled, killed and resumed. Every learner run raises
   unless the learner answered every decision (no fallback, no degraded
   answer, no breaker trip, no shed, no deadline) with 4 flash and 24 GEMM
   launches a batch on the tensor cores, and each resumed run must end
   with its uninterrupted run's schedules; (a) and (b) print decisions/s,
   the decision latency's p50 and p99, rounds, batches and the batch-size
   histogram; then one full 64-lane service batch, and the decision alone
   on its states, under torch.profiler;
8. Mamba2-1.3B training at its full published width, seeded weights drawn
   on the card, ``make_train_step`` at the train launcher's optimizer (lr
   3e-4, warmup 20) on ``data_iterator`` batches: (a) the launcher's
   defaults, 8 x 128, 5 steps; (b) 2 x 2048 (8 chunks of 256), 3 steps; each
   after a warm-up step, with ms per step, tokens/s, the losses (all
   finite) and the peak memory, raising unless every micro-batch pass
   launched exactly 97 RMSNorm and 48 SSD kernels forward and as many
   backward, all vectorised / on the tensor cores both ways; (c) one step
   of (a) in two micro-batches, its loss against the single batch's; the
   first 2 layers' gradients at 1 x 512 held leaf by leaf against the CPU
   plain path; one (b) step under torch.profiler,
   its device time split into cuBLAS, the scan's and the norms' kernels
   forward and backward, AdamW (profiled alone) and the other elementwise
   work; then ``repro_torch.launch.train --smoke`` for 3 steps, again for 3
   resumed ("resumed at step 3") against an uninterrupted 6-step run, and
   ``launch.serve --smoke --ckpt-dir`` serving from its checkpoint;
5. each kernel's time at the serving paths' shapes (L2 flushed before each
   launch) beside its plain version, the PyTorch library call that
   computes the same function, and the least time the card could take
   (its bound); for every kernel also the variant that ran (by the launch
   counters of the timed calls), the other variant's time at the same shape
   (``simt_ms``: the CUDA-core kernels, and RMSNorm's one element per
   lane), the wrapper's host time per call, and the time without the card's
   lead (the ruler of earlier runs, see ``time_ms``); flash's streaming
   form at a long sequence beside its CUDA-core variant and the library
   call; and RMSNorm at the decode step's 4 rows; and the backward kernels
   at the trunk's shapes (flash's at one layer; the GEMM's fused backward
   of one layer's 6 projections beside the earlier two-launch route of the
   same products) beside SDPA's backward and ``torch.bmm``, with the GEMM
   backward's host time split into its parts; and the RMSNorm and SSD
   backward kernels at phase 8's (b) shapes (the fast variant as ``ms``,
   the "simt" one as ``simt_ms``) beside their plain versions and, for
   RMSNorm, autograd through ``F.rms_norm``.

Phases run in the order 1, 2, 3, 4, 4b, 6, 7, 8, 5, and each ends with a
``[phase]`` line of its wall time. Each kernel's ``launches`` in the JSON record sums
the counts of every path that runs it (phases 3, 4, 4b, 6, 7 and 8: runs
(a), (b) and (c)), each counted from 0 just before its path and read just
after.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import io
import json
import shutil
import subprocess
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import mamba2_1_3b, mirage_agent  # noqa: E402
from repro_torch.convert import tree_map  # noqa: E402
from repro_torch.core import (ALL_METHODS, ChainDriver,  # noqa: E402
                              CircuitBreaker, DecisionJournal, DQNConfig,
                              DQNLearner, EnvConfig, FoundationConfig,
                              LearnerPolicy, PGConfig, PGLearner, Policy,
                              ReactivePolicy, ReplayCheckpointCache,
                              RetryPolicy, build_policy, stack_obs,
                              collect_offline_samples, evaluate_batch,
                              init_foundation, pretrain_foundation, q_values,
                              train_online_dqn, train_online_pg)
from repro_torch.core.dqn import value_and_grad  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_lse_ref, flash_attention_ref)
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    _flash_variant, _launch as flash_launch, _launch_bwd as flash_launch_bwd)
from repro_torch.kernels.moe_gemm import (grouped_gemm,  # noqa: E402
                                          grouped_gemm_bwd_ref,
                                          grouped_gemm_ref)
from repro_torch.kernels.moe_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.moe_gemm.ops import (  # noqa: E402
    _launch as gemm_launch)
from repro_torch.data import DataConfig, data_iterator, synth_batch  # noqa: E402
from repro_torch.kernels.rmsnorm import (rmsnorm, rmsnorm_bwd,  # noqa: E402
                                         rmsnorm_bwd_ref, rmsnorm_ref)
from repro_torch.kernels.rmsnorm import ops as norm_ops  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import (  # noqa: E402
    _launch as norm_launch, _launch_bwd as norm_launch_bwd)
from repro_torch.kernels.ssd import (ssd, ssd_bwd, ssd_bwd_ref,  # noqa: E402
                                     ssd_ref)
from repro_torch.kernels.ssd import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.ssd.ops import _launch as ssd_launch  # noqa: E402
from repro_torch.kernels.ssd.ops import (  # noqa: E402
    _launch_bwd as ssd_launch_bwd)
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import ProvisionService, ServiceConfig  # noqa: E402
from repro_torch.sim import (LOAD_LEVELS, PROFILES,  # noqa: E402
                             get_fault_spec, get_scenario, iter_scenarios,
                             make_env, make_vector_env, synthesize_trace)
from repro_torch.train import (OptimizerConfig, adamw_update,  # noqa: E402
                               init_opt_state, make_prefill_step,
                               make_serve_step, make_train_step)
from repro_torch.train.step import (  # noqa: E402
    value_and_grad as value_and_grad_aux)

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16
# tensor-core FLOP/s and fp32 FLOP/s outside the tensor cores; the bound of
# a kernel is the larger of its bytes over the first and its operations
# over the peak for their type
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
L2_FLUSH_BYTES = 256 << 20     # written before each timed launch (L2: 50 MB)
HOST_LEAD_CYCLES = 200_000_000  # the card's sleep before a timed loop, ~0.1 s

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
FP32_NORM_TOL = 1e-5    # the repo's bounds for the Pallas kernels in fp32
FP32_SSD_TOL = 5e-5
FP32_FLASH_BWD_RTOL = 1e-5  # dq, dk, dv sum up to 1001 terms in two orders
FP32_GEMM_BWD_TOL = 2e-5    # dW sums C = 1001 terms in two orders
LSE_ATOL = 1e-4         # the forward's row log-sum-exp against the plain one

# the training phase (3b): sizes chosen to fit the script's time limit
TRAIN_SAMPLE_EPISODES, TRAIN_SAMPLE_POINTS = 4, 8   # 32 offline samples
PRETRAIN_BATCH, PRETRAIN_EPOCHS = 16, 2             # 4 pretraining steps
# 4 rollouts of 8 lanes: even if every episode ended at its first decision,
# the replay would reach a batch of 32 by the last one
DQN_EPISODES, DQN_LANES, DQN_BATCH = 32, 8, 32
PG_EPISODES = 4
GRAD_CHECK_BATCH = 4    # the full-width gradient check against the CPU
GRAD_REL_TOL = 2e-2     # of each leaf's largest gradient magnitude (bf16)
PROFILE_TRAIN_STEPS = 3
GEMM_BWD_PER_LAYER = 2 * GEMMS_PER_LAYER            # dX and dW per GEMM

# the Fig-8 grid (phase 6): one cluster's single-node cells at
# benchmarks/common.py's QUICK counts, the agent at its full width
INTERVAL = 600.0                # seconds between decisions, as at history 144
GRID_CLUSTER = "V100"
GRID_MONTHS, GRID_EVAL_LANES = 1, 5
GRID_ONLINE_EPISODES, GRID_PRETRAIN_EPOCHS, GRID_OFFLINE_EPISODES = 6, 5, 4
CO_EPISODES, CO_TENANTS = 16, 8     # cross-tenant training: 2 groups of 8
# the provisioning service (phase 7): benchmarks/bench_serve.py's fleets
DAY = 24 * 3600.0
SERVICE_TENANTS, SERVICE_CO_TENANTS, SERVICE_MAX_BATCH = 128, 1024, 64
SERVICE_SUB_LIMIT = 6 * 3600.0
SERVICE_SEED = 17
JOURNAL_TENANTS = 8             # 8 tenants x 2 links, journaled

LM = mamba2_1_3b.CONFIG
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 32
LM_PLAIN_LAYERS, LM_PLAIN_PROMPT = 2, 512   # the kernel-vs-plain model check
NORMS_PER_PASS = 2 * LM.n_layers + 1        # block norms, out_norms, final
LM_REL_TOL = 2e-2       # bf16 model outputs: 2e-2 of the output's largest
                        # magnitude (a few bf16 ulps, as in the CPU tests)
FP32_BWD_REL_TOL = 1e-4  # the RMSNorm and SSD backward kernels against their
BF16_BWD_REL_TOL = 2e-2  # plain versions: of each gradient's largest value
# Mamba2-1.3B training (phase 8): the launcher's optimizer and defaults
TRAIN_OCFG = OptimizerConfig(lr=3e-4, warmup_steps=20, total_steps=10**9)
LM_TRAIN_RUNS = (("a", 8, 128, 5), ("b", 2, 2048, 3))   # batch, seq, steps
LM_GRAD_SEQ = 512       # the 2-layer gradient check: 1 x 512, two chunks
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"


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


def ssd_inputs(gen, Bz, S, H, P, N, G, dtype, init):
    """x, dt, A, B, C, D, initial state at the scales of the repo's SSD
    tests (tests/test_kernels.py: x 0.5 N(0,1), B and C 0.3 N(0,1),
    A -exp(0.3 N(0,1)), D 1), but with the model's small steps,
    dt = softplus(N(0,1) - 3), about 0.07: with the tests' dt of about 0.8
    the within-chunk cumsum over 256 steps reaches ~-200, and its fp32
    rounding alone nears the fp32 bound (tests/test_torch_ssm.py holds the
    plain version within 1e-5 of an fp64 scan at the model's dt)."""
    x = _randn(gen, (Bz, S, H, P), dtype, 0.5)
    dt = F.softplus(_randn(gen, (Bz, S, H), torch.float32) - 3.0)
    A = -torch.exp(_randn(gen, (H,), torch.float32, 0.3))
    B = _randn(gen, (Bz, S, G, N), dtype, 0.3)
    C = _randn(gen, (Bz, S, G, N), dtype, 0.3)
    D = torch.ones(H, device="cuda")
    s0 = _randn(gen, (Bz, H, P, N), torch.float32, 0.3) if init else None
    return x, dt, A, B, C, D, s0


def _err(out, ref, atol, rtol, what):
    out, ref = out.float(), ref.float()
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, atol=atol, rtol=rtol, msg=lambda m:
                               f"{what}: kernel disagrees with plain: {m}")
    return err


def _fast(kernel):
    """The name of ``kernel``'s fast variant and the count of its launches:
    16-byte vectors for RMSNorm, the tensor cores for the others."""
    if kernel is rmsnorm:
        return "vec", kernel.vec_launches
    return "tc", kernel.tc_launches


def _run_variant(kernel, variant: str, name: str, fn):
    """``fn()``, synchronised, after checking through the kernel's counters
    that it launched once and ran ``variant``."""
    n, n_fast = kernel.launches, _fast(kernel)[1]
    out = fn()
    torch.cuda.synchronize()
    ran = (kernel.launches - n, _fast(kernel)[1] - n_fast)
    if ran != (1, int(variant != "simt")):
        raise RuntimeError(f"{name}: expected one {variant} launch, counted "
                           f"{ran} (launches, {_fast(kernel)[0]} launches)")
    return out


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    B = 2 * LANES * mirage_agent.N_EXPERTS
    errs = {}
    # flash: both variants (bf16 on the tensor cores, fp32 on the CUDA
    # cores), every head dim's tensor-core path, and q, k, v as strided views
    # of one fused (B, S, 3, H, D) tensor
    cases = [
        ("flash agent (640,144,8,32) bf16", dict(causal=False),
         (B, HISTORY, HISTORY, 8, 8, 32, torch.bfloat16), "tc", BF16_TOL,
         BF16_TOL),
        ("flash causal GQA window softcap (2,97|131,8/2,64) bf16",
         dict(causal=True, window=40, softcap=30.0),
         (2, 97, 131, 8, 2, 64, torch.bfloat16), "tc", BF16_TOL, BF16_TOL),
        ("flash causal GQA window softcap (2,97|131,8/2,64) fp32",
         dict(causal=True, window=40, softcap=30.0),
         (2, 97, 131, 8, 2, 64, torch.float32), "simt", FP32_FLASH_TOL, 0.0),
        ("flash (3,50,4,16) bf16", dict(causal=False),
         (3, 50, 50, 4, 4, 16, torch.bfloat16), "tc", BF16_TOL, BF16_TOL),
        ("flash causal (1,200,4,128) bf16", dict(causal=True),
         (1, 200, 200, 4, 4, 128, torch.bfloat16), "tc", BF16_TOL, BF16_TOL),
        ("flash fused qkv views (2,77,3,4,64) bf16", dict(causal=True),
         "fused", "tc", BF16_TOL, BF16_TOL),
    ]
    for name, opts, shape, variant, atol, rtol in cases:
        if shape == "fused":
            q, k, v = _randn(gen, (2, 77, 3, 4, 64), torch.bfloat16).unbind(2)
        else:
            q, k, v = flash_inputs(gen, *shape)
        out = _run_variant(flash_attention, variant, name,
                           lambda: flash_attention(q, k, v, **opts))
        err = _err(out, flash_attention_ref(q, k, v, **opts), atol, rtol, name)
        errs["flash_attention"] = max(errs.get("flash_attention", 0.0), err)
        line("check", case=name, variant=variant, max_abs_err=err, atol=atol,
             rtol=rtol)
    # the GEMM: every projection shape of the trunk (q, k, v, o; ffn in;
    # ffn out) and a ragged one on the tensor cores, expert_mlp's strided
    # gate view, and on the CUDA cores fp32 and an f (53) under TMA's
    # 16-byte rule
    E, C = mirage_agent.N_EXPERTS, 2 * LANES * HISTORY
    d, f = TRUNK.d_model, TRUNK.d_ff
    cases = [(f"gemm ({E},{C},{a})x({E},{a},{b}) bf16",
              (E, C, a, b, torch.bfloat16), "tc", BF16_TOL)
             for a, b in ((d, d), (d, f), (f, d))]
    cases += [
        (f"gemm trunk layout, x stored ({C},{E},{d}) bf16", "rows", "tc",
         BF16_TOL),
        ("gemm ragged (3,1001,200)x(3,200,136) bf16",
         (3, 1001, 200, 136, torch.bfloat16), "tc", BF16_TOL),
        (f"gemm gate view wi[:, :, 0, :] of (3,{d},2,{f}), C=1000 bf16",
         "gate", "tc", BF16_TOL),
        ("gemm (10,300,41)x(10,41,256) fp32",
         (10, 300, 41, 256, torch.float32), "simt", FP32_GEMM_TOL),
        ("gemm unaligned (1,37,1024)x(1,1024,53) bf16",
         (1, 37, 1024, 53, torch.bfloat16), "simt", BF16_TOL),
    ]
    for name, shape, variant, tol in cases:
        if shape == "gate":
            x, wi = gemm_inputs(gen, 3, 1000, d, 2 * f, torch.bfloat16)
            w = wi.view(3, d, 2, f)[:, :, 0, :]
        elif shape == "rows":     # the expert axis inside the rows
            x, w = gemm_inputs(gen, E, C, d, d, torch.bfloat16)
            x = x.transpose(0, 1).contiguous().transpose(0, 1)
        else:
            x, w = gemm_inputs(gen, *shape)
        out = _run_variant(grouped_gemm, variant, name,
                           lambda: grouped_gemm(x, w))
        err = _err(out, grouped_gemm_ref(x, w), tol, tol, name)
        errs["grouped_gemm"] = max(errs.get("grouped_gemm", 0.0), err)
        line("check", case=name, variant=variant, max_abs_err=err, atol=tol,
             rtol=tol)
        del x, w, out
    # the Mamba2-1.3B norms, vectorised: prefill rows (4 x 2048) of d_model
    # and d_inner, a decode step's 4 rows, an fp32 gemma case and a ragged
    # fp32 width; one element per lane: d = 300 in bf16 (off 16 bytes) and
    # rows one element off a 16-byte boundary in bf16 and fp32
    d, din = LM.d_model, LM.d_inner
    cases = [(f"rmsnorm ({r},{c}) bf16, w fp32", (r, c, torch.bfloat16),
              False, "plain", "vec", BF16_TOL)
             for r, c in ((LM_BATCH * LM_PROMPT, d), (LM_BATCH * LM_PROMPT, din),
                          (LM_BATCH, d), (LM_BATCH, din))]
    cases += [
        ("rmsnorm (300,2048) fp32 gemma", (300, 2048, torch.float32), True,
         "plain", "vec", FP32_NORM_TOL),
        ("rmsnorm (33,300) fp32", (33, 300, torch.float32), False, "plain",
         "vec", FP32_NORM_TOL),
        ("rmsnorm (33,300) bf16 gemma", (33, 300, torch.bfloat16), True,
         "plain", "simt", BF16_TOL),
        ("rmsnorm offset view (64,4096) bf16", (64, 4096, torch.bfloat16),
         False, "offset", "simt", BF16_TOL),
        ("rmsnorm offset view (300,2048) fp32 gemma",
         (300, 2048, torch.float32), True, "offset", "simt", FP32_NORM_TOL),
    ]
    for name, (rows, dim, dtype), gemma, layout, variant, tol in cases:
        x = _randn(gen, (rows, dim), dtype, 3.0)
        if layout == "offset":      # one element past a 16-byte boundary
            x = torch.cat([x.new_zeros(1), x.flatten()])[1:].view(rows, dim)
        w = _randn(gen, (dim,), torch.float32)
        out = _run_variant(rmsnorm, variant, name, lambda: rmsnorm(
            x, w, eps=LM.norm_eps, gemma=gemma))
        err = _err(out, rmsnorm_ref(x, w, eps=LM.norm_eps, gemma=gemma),
                   tol, tol, name)
        errs["rmsnorm"] = max(errs.get("rmsnorm", 0.0), err)
        line("check", case=name, variant=variant, max_abs_err=err, atol=tol,
             rtol=tol)
    # the scan on the tensor cores at the prefill shape, ragged with groups
    # and an initial state, at P = 128 and at a chunk of 64; on the CUDA cores
    # in fp32, ragged with groups and an initial state; y and the final state
    # both checked
    cases = [
        ("ssd prefill (4,2048,64,64) N=128 G=1 chunk 256 bf16",
         (LM_BATCH, LM_PROMPT, LM.ssm_nheads, LM.ssm_headdim, LM.ssm_state,
          LM.ssm_ngroups, torch.bfloat16, False), LM.ssm_chunk, "tc",
         BF16_TOL, BF16_TOL),
        ("ssd ragged (2,1000,8,64) N=128 G=2 chunk 256 bf16, initial state",
         (2, 1000, 8, 64, 128, 2, torch.bfloat16, True), 256, "tc", BF16_TOL,
         BF16_TOL),
        ("ssd (1,517,2,128) N=128 chunk 256 bf16, initial state",
         (1, 517, 2, 128, 128, 1, torch.bfloat16, True), 256, "tc", BF16_TOL,
         BF16_TOL),
        ("ssd (2,300,4,32) N=64 G=2 chunk 64 bf16",
         (2, 300, 4, 32, 64, 2, torch.bfloat16, False), 64, "tc", BF16_TOL,
         BF16_TOL),
        ("ssd ragged (2,1000,8,64) N=128 G=2 chunk 256 fp32, initial state",
         (2, 1000, 8, 64, 128, 2, torch.float32, True), 256, "simt",
         FP32_SSD_TOL, 0.0),
    ]
    for name, shape, chunk, variant, atol, rtol in cases:
        args = ssd_inputs(gen, *shape)
        y, final = _run_variant(ssd, variant, name,
                                lambda: ssd(*args[:6], chunk, args[6]))
        y_ref, final_ref = ssd_ref(*args[:6], chunk, args[6])
        err = max(_err(y, y_ref, atol, rtol, name + " y"),
                  _err(final, final_ref, atol, rtol, name + " state"))
        errs["ssd"] = max(errs.get("ssd", 0.0), err)
        line("check", case=name, variant=variant, max_abs_err=err, atol=atol,
             rtol=rtol)
        del args, y, final, y_ref, final_ref
    check_backward(gen, errs)
    check_lm_backward(gen, errs)
    return errs


def _bwd_counts():
    return (flash_attention_bwd.launches, grouped_gemm.bwd_launches,
            grouped_gemm.bwd_tc_launches, flash_attention_bwd.tc_launches)


def check_backward(gen, errs: dict) -> None:
    """The backward kernels through autograd, as training runs them, against
    their plain versions on the same inputs. Flash: the forward keeps each
    row's log-sum-exp (held against the plain one), and dq, dk, dv of one
    backward launch of the variant named are held against
    ``flash_attention_bwd_ref`` on the forward's out; the tensor-core
    variant at every head dim it takes, causal, softcap and ragged, the
    CUDA-core one for GQA, D = 128, long sequences and fp32. The GEMM: dX
    and dW against ``grouped_gemm_bwd_ref``, in bf16 from one launch of the
    fused backward kernel (counted once in ``bwd_fused_calls``; dW split
    along C and the same bit for bit over two more calls), with x or dY
    strided as the trunk stores its activations; in fp32 from two launches
    of the CUDA-core kernel. At each bf16 case the two-launch route that
    phase 5 times beside it is held to the same tolerance."""
    B = 2 * LANES * mirage_agent.N_EXPERTS
    bf16 = torch.bfloat16
    cases = [
        ("flash bwd agent (640,144,8,32) bf16", dict(causal=False,
                                                     softcap=0.0),
         (B, HISTORY, HISTORY, 8, 8, 32, bf16), "tc", BF16_TOL, BF16_TOL),
        ("flash bwd softcap (3,50,4,16) bf16", dict(causal=False,
                                                   softcap=30.0),
         (3, 50, 50, 4, 4, 16, bf16), "tc", BF16_TOL, BF16_TOL),
        ("flash bwd causal softcap (2,97|131,4,64) bf16",
         dict(causal=True, softcap=30.0), (2, 97, 131, 4, 4, 64, bf16), "tc",
         BF16_TOL, BF16_TOL),
        ("flash bwd fused qkv views (2,77,3,4,64) bf16",
         dict(causal=True, softcap=0.0), "fused", "tc", BF16_TOL, BF16_TOL),
        ("flash bwd causal GQA ragged (2,1001,8/2,64) bf16",
         dict(causal=True, softcap=0.0), (2, 1001, 1001, 8, 2, 64, bf16),
         "simt", BF16_TOL, BF16_TOL),
        ("flash bwd causal softcap GQA (1,200,4/2,128) bf16",
         dict(causal=True, softcap=30.0), (1, 200, 200, 4, 2, 128, bf16),
         "simt", BF16_TOL, BF16_TOL),
        ("flash bwd causal GQA softcap (2,97|131,8/2,64) fp32",
         dict(causal=True, softcap=30.0), (2, 97, 131, 8, 2, 64,
                                            torch.float32),
         "simt", FP32_FLASH_TOL, FP32_FLASH_BWD_RTOL),
    ]
    for name, opts, shape, variant, atol, rtol in cases:
        if shape == "fused":
            base = _randn(gen, (2, 77, 3, 4, 64), torch.bfloat16)
            base.requires_grad_(True)
            leaves = [base]
            q, k, v = base.unbind(2)
        else:
            q, k, v = (t.requires_grad_(True)
                       for t in flash_inputs(gen, *shape))
            leaves = [q, k, v]
        do = _randn(gen, q.shape, q.dtype)
        before = _bwd_counts()
        out = flash_attention(q, k, v, **opts)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        after = _bwd_counts()
        if (after[0] - before[0], after[3] - before[3]) != \
                (1, int(variant == "tc")):
            raise RuntimeError(f"{name}: expected one {variant} backward "
                               f"launch, counted {before} -> {after}")
        q, k, v, out = (t.detach() for t in (q, k, v, out))
        if shape == "fused":
            grads = grads[0].unbind(2)
        _, lse = flash_launch(q, k, v, _flash_variant(q, k, v), window=0,
                              scale=q.shape[3] ** -0.5, lse=True, **opts)
        lse_err = _err(lse, flash_attention_lse_ref(q, k, **opts), LSE_ATOL,
                       1e-5, name + " lse")
        refs = flash_attention_bwd_ref(q, k, v, out, lse, do, **opts)
        err = max(_err(g, r, atol, rtol, f"{name} d{n}")
                  for n, g, r in zip("qkv", grads, refs))
        errs["flash_attention_bwd"] = max(
            errs.get("flash_attention_bwd", 0.0), err)
        line("check", case=name, variant=variant, max_abs_err=err,
             lse_max_abs_err=lse_err, atol=atol, rtol=rtol)
        del q, k, v, out, grads, refs, leaves, do
    E, C = mirage_agent.N_EXPERTS, 2 * LANES * HISTORY
    d, f = TRUNK.d_model, TRUNK.d_ff
    cases = [(f"gemm bwd ({E},{C},{a})x({E},{a},{b}) bf16",
              (E, C, a, b, bf16), "plain", BF16_TOL)
             for a, b in ((d, d), (d, f), (f, d))]
    cases += [(f"gemm bwd trunk layout, x stored ({C},{E},{d}) bf16",
               (E, C, d, d, bf16), "x_rows", BF16_TOL),
              (f"gemm bwd dY stored (2000,{E},{d}) bf16",
               (E, 2000, d, d, bf16), "dy_rows", BF16_TOL),
              ("gemm bwd ragged (3,1001,200)x(3,200,136) bf16",
               (3, 1001, 200, 136, bf16), "plain", BF16_TOL),
              ("gemm bwd ragged (3,1001,200)x(3,200,136) fp32",
               (3, 1001, 200, 136, torch.float32), "plain",
               FP32_GEMM_BWD_TOL)]
    for name, shape, layout, tol in cases:
        x, w = gemm_inputs(gen, *shape)
        dy = _randn(gen, (shape[0], shape[1], shape[3]), shape[4])
        if layout == "x_rows":
            x = x.transpose(0, 1).contiguous().transpose(0, 1)
        if layout == "dy_rows":
            dy = dy.transpose(0, 1).contiguous().transpose(0, 1)
        x.requires_grad_(True)
        w.requires_grad_(True)
        before, calls = _bwd_counts(), grouped_gemm.bwd_fused_calls
        dx, dw = torch.autograd.grad(grouped_gemm(x, w), (x, w), dy)
        torch.cuda.synchronize()
        n, n_tc = (a - b for a, b in zip(_bwd_counts()[1:3], before[1:3]))
        fused = grouped_gemm.bwd_fused_calls - calls
        bf = shape[4] == bf16
        if (n, n_tc, fused) != ((2, 2, 1) if bf else (2, 0, 0)):
            raise RuntimeError(f"{name}: {n} backward products ({n_tc} on "
                               f"the tensor cores) in {fused} fused calls")
        xd, wd = x.detach(), w.detach()
        rdx, rdw = grouped_gemm_bwd_ref(xd, wd, dy)
        err = max(_err(dx, rdx, tol, tol, name + " dX"),
                  _err(dw, rdw, tol, tol, name + " dW"))
        extra = {}
        if bf:
            for _ in range(2):
                if not torch.equal(gemm_ops._launch_bwd(xd, wd, dy, True,
                                                        True)[1], dw):
                    raise RuntimeError(f"{name}: dW differs between calls")
            odx, odw = gemm_ops._backward_two_launches(xd, wd, dy, True, True)
            extra = {"splits": gemm_ops.split_count(
                         shape[0], shape[2], shape[3], shape[1],
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count),
                     "dw_bit_identical": True,
                     "two_launch_max_abs_err": max(
                         _err(odx, rdx, tol, tol, name + " two-launch dX"),
                         _err(odw, rdw, tol, tol, name + " two-launch dW"))}
        errs["grouped_gemm_bwd"] = max(errs.get("grouped_gemm_bwd", 0.0),
                                       err)
        line("check", case=name, variant="tc" if bf else "simt",
             route="fused" if bf else "two launches", max_abs_err=err,
             atol=tol, rtol=tol, **extra)
        del x, w, dy, dx, dw, rdx, rdw, xd, wd


def _rel_err(out, ref, what, tol=LM_REL_TOL) -> float:
    """max|out - ref|, raising unless within ``tol`` of ref's largest
    magnitude."""
    out, ref = out.float().cpu(), ref.float().cpu()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"{what}: bad output {out.shape} vs {ref.shape}")
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    if err > tol * scale:
        raise RuntimeError(f"{what}: kernel path off the plain path by {err}"
                           f" (scale {scale}, tolerance {tol} of it)")
    return err


def check_lm_backward(gen, errs: dict) -> None:
    """The RMSNorm and SSD backward kernels through autograd, as Mamba2
    training runs them, against their plain versions on the same inputs
    (fp32 1e-4, bf16 2e-2 of each gradient's largest value): one forward
    and one backward launch each, of the variant the case names (counted:
    "vec" / "tc" for bf16 rows and chunks they can address), and the
    reductions (RMSNorm's dw; the scan's dA, dB, dC, dD) the same bit for
    bit over two more calls; where that variant is the fast one, the other
    ("simt") on the same inputs, held to the same bound."""
    bf16, f32 = torch.bfloat16, torch.float32
    d, din = LM.d_model, LM.d_inner
    cases = [(f"rmsnorm bwd ({r},{c}) bf16, w fp32", r, c, bf16, False, "vec")
             for r, c in ((8 * 128, d), (2 * 2048, d), (2 * 2048, din))]
    cases += [("rmsnorm bwd (4096,2048) bf16 gemma", 4096, d, bf16, True,
               "vec"),
              ("rmsnorm bwd (4096,4096) fp32, past the vectors", 4096, din,
               f32, False, "simt"),
              ("rmsnorm bwd ragged (37,2048) fp32 gemma", 37, d, f32, True,
               "vec"),
              ("rmsnorm bwd (37,300) bf16, d off 8", 37, 300, bf16, False,
               "simt"),
              ("rmsnorm bwd (33,300) fp32 gemma", 33, 300, f32, True, "vec")]
    for name, rows, dim, dtype, gemma, variant in cases:
        x = _randn(gen, (rows, dim), dtype, 3.0).requires_grad_(True)
        w = (1.0 + 0.1 * _randn(gen, (dim,), f32)).requires_grad_(True)
        dy = _randn(gen, (rows, dim), dtype)
        n, nb, nv = (rmsnorm.launches, rmsnorm.bwd_launches,
                     rmsnorm.bwd_vec_launches)
        dx, dw = torch.autograd.grad(rmsnorm(x, w, eps=LM.norm_eps,
                                             gemma=gemma), (x, w), dy)
        torch.cuda.synchronize()
        ran = (rmsnorm.launches - n, rmsnorm.bwd_launches - nb,
               rmsnorm.bwd_vec_launches - nv)
        if ran != (1, 1, int(variant == "vec")):
            raise RuntimeError(f"{name}: expected one {variant} backward, "
                               f"counted (launches, bwd, bwd vec) {ran}")
        xd, wd = x.detach(), w.detach()
        rdx, rdw = rmsnorm_bwd_ref(xd, wd, dy, eps=LM.norm_eps, gemma=gemma)
        tol = FP32_BWD_REL_TOL if dtype == f32 else BF16_BWD_REL_TOL
        err = max(_rel_err(dx, rdx, name + " dx", tol),
                  _rel_err(dw, rdw, name + " dw", tol))
        for _ in range(2):
            if not torch.equal(norm_launch_bwd(xd, wd, dy, variant,
                                               eps=LM.norm_eps,
                                               gemma=gemma)[1], dw):
                raise RuntimeError(f"{name}: dw differs between calls")
        extra = {}
        if variant == "vec":
            sdx, sdw = norm_launch_bwd(xd, wd, dy, "simt", eps=LM.norm_eps,
                                       gemma=gemma)
            extra["simt_max_abs_err"] = max(
                _rel_err(sdx, rdx, name + " simt dx", tol),
                _rel_err(sdw, rdw, name + " simt dw", tol))
            err = max(err, extra["simt_max_abs_err"])
        errs["rmsnorm_bwd"] = max(errs.get("rmsnorm_bwd", 0.0), err)
        line("check", case=name, variant=variant, max_abs_err=err,
             rel_tol=tol, dw_bit_identical=True, **extra)
        del x, w, dy, dx, dw, rdx, rdw, xd, wd
    H, P, N = LM.ssm_nheads, LM.ssm_headdim, LM.ssm_state
    cases = [
        ("ssd bwd (2,2048,64,64) N=128 G=1 chunk 256 bf16",
         (2, 2048, H, P, N, 1, bf16, False), 256, False),
        ("ssd bwd one chunk (8,128,64,64) N=128 G=1 chunk 256 bf16",
         (8, 128, H, P, N, 1, bf16, False), 256, False),
        ("ssd bwd (2,2048,64,64) N=128 G=1 chunk 256 fp32, initial state "
         "and d_final", (2, 2048, H, P, N, 1, f32, True), 256, True),
        ("ssd bwd ragged (2,300,8,64) N=128 G=2 chunk 256 bf16, initial "
         "state and d_final", (2, 300, 8, P, N, 2, bf16, True), 256, True),
        ("ssd bwd ragged (2,300,8,64) N=128 G=2 chunk 128 fp32, initial "
         "state", (2, 300, 8, P, N, 2, f32, True), 128, False),
        # chunks whose length is not a multiple of the backward's tiles
        ("ssd bwd one chunk of 100 (1,100,64,64) N=128 G=1 chunk 256 fp32, "
         "initial state and d_final", (1, 100, H, P, N, 1, f32, True), 256,
         True),
        ("ssd bwd one chunk of 100 (2,100,64,64) N=128 G=1 chunk 256 bf16",
         (2, 100, H, P, N, 1, bf16, False), 256, False),
        ("ssd bwd chunks of 100 then 50 (1,250,8,64) N=128 G=2 chunk 100 "
         "bf16, initial state and d_final", (1, 250, 8, P, N, 2, bf16, True),
         100, True),
        ("ssd bwd the smoke config's scan (2,40,8,16) N=16 chunk 16 fp32, "
         "initial state and d_final", (2, 40, 8, 16, 16, 1, f32, True), 16,
         True),
        ("ssd bwd P = N = chunk = 16 (2,40,8,16) bf16, initial state and "
         "d_final", (2, 40, 8, 16, 16, 1, bf16, True), 16, True),
        ("ssd bwd P = 128 (1,97,2,128) N=128 chunk 64 bf16, initial state",
         (1, 97, 2, 128, 128, 1, bf16, True), 64, False),
    ]
    for name, shape, chunk, dfin in cases:
        variant = "tc" if shape[6] == bf16 else "simt"
        args = ssd_inputs(gen, *shape)
        leaves = [t.requires_grad_(True) for t in args if t is not None]
        x, dt, A, B, C, D = leaves[:6]
        s0 = leaves[6] if len(leaves) > 6 else None
        dy = _randn(gen, x.shape, x.dtype)
        d_final = (_randn(gen, (x.shape[0], *x.shape[2:], B.shape[3]), f32,
                          0.3)
                   if dfin else None)
        n, nb, ntc = ssd.launches, ssd.bwd_launches, ssd.bwd_tc_launches
        y, final = ssd(x, dt, A, B, C, D, chunk, s0)
        outs, grads_in = ((y, final), (dy, d_final)) if dfin else ((y,), (dy,))
        grads = torch.autograd.grad(outs, leaves, grads_in)
        torch.cuda.synchronize()
        ran = (ssd.launches - n, ssd.bwd_launches - nb,
               ssd.bwd_tc_launches - ntc)
        if ran != (1, 1, int(variant == "tc")):
            raise RuntimeError(f"{name}: expected one {variant} backward, "
                               f"counted (launches, bwd, bwd tc) {ran}")
        det = [t.detach() for t in leaves]
        s0d = det[6] if s0 is not None else None
        refs = ssd_bwd_ref(*det[:6], chunk, dy, s0d, d_final)
        tol = FP32_BWD_REL_TOL if shape[6] == f32 else BF16_BWD_REL_TOL
        names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinit")
        err = max(_rel_err(g, r, f"{name} {what}", tol) for g, r, what in zip(
            grads, refs, names))
        Q = min(chunk, shape[1])
        for _ in range(2):
            again = ssd_launch_bwd(*det[:6], Q, dy, s0d, d_final, variant)
            if not all(torch.equal(again[i], grads[i]) for i in (2, 3, 4, 5)):
                raise RuntimeError(f"{name}: dA, dB, dC or dD differ "
                                   "between calls")
        extra = {}
        if variant == "tc":
            other = ssd_launch_bwd(*det[:6], Q, dy, s0d, d_final, "simt")
            extra["simt_max_abs_err"] = max(
                _rel_err(g, r, f"{name} simt {what}", tol)
                for g, r, what in zip(other, refs, names) if r is not None)
            err = max(err, extra["simt_max_abs_err"])
            del other
        errs["ssd_bwd"] = max(errs.get("ssd_bwd", 0.0), err)
        line("check", case=name, variant=variant, max_abs_err=err,
             rel_tol=tol, reductions_bit_identical=True, **extra)
        del args, leaves, grads, refs, det, again, y, final, dy


# ------------------------------------------------- 3. agent serving
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
    """``evaluate_batch`` of ``policy`` over LANES lockstep episodes. On the
    kernel path every flash and GEMM launch must have run the tensor-core
    variant, decisions x layers x launches per layer of each."""
    timed = TimedPolicy(policy)
    kernels = (flash_attention, grouped_gemm)
    _zero_forward_counts()
    t0 = time.perf_counter()
    res = evaluate_batch(venv, timed, seed=1)
    wall = time.perf_counter() - t0
    (flash, flash_tc), (gemm, gemm_tc) = ((k.launches, k.tc_launches)
                                          for k in kernels)
    decisions = len(timed.ms)
    layers = TRUNK.n_layers if kernel_path else 0
    if (kernel_path and not flash) or \
            flash != decisions * layers * FLASH_PER_LAYER or \
            gemm != decisions * layers * GEMMS_PER_LAYER or \
            (flash_tc, gemm_tc) != (flash, gemm):
        raise RuntimeError(f"{name}: {flash} flash ({flash_tc} on the tensor "
                           f"cores) and {gemm} GEMM ({gemm_tc}) launches for "
                           f"{decisions} decision batches")
    summary = res.summary()
    if summary["n_episodes"] != LANES:
        raise RuntimeError(f"{name}: {summary['n_episodes']} episodes")
    ms = np.asarray(timed.ms)
    line("serve", method=name, summary=summary, decision_batches=decisions,
         flash_launches=flash, flash_tc_launches=flash_tc,
         gemm_launches=gemm, gemm_tc_launches=gemm_tc,
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


def profile_device(what: str, fn, units: int, unit: str, warmup: int = 1,
                   **meta) -> dict:
    """``fn()`` under torch.profiler, after ``warmup`` calls: host wall
    time per ``unit`` (``fn`` does ``units`` of them), the share of the
    wall the card was busy (the union of kernel intervals), and device time
    per kernel name, largest first."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    rec = {"what": what, **meta, f"{unit}s": units,
           f"wall_ms_per_{unit}": wall_us / units / 1e3,
           "device_busy_share": _union_us(intervals) / wall_us,
           f"device_ms_per_{unit}": sum(us for _, us in per_name.values())
           / units / 1e3,
           f"device_calls_per_{unit}": len(intervals) / units,
           "kernels": [{"name": n[:120], f"calls_per_{unit}": c / units,
                        f"ms_per_{unit}": us / units / 1e3}
                       for n, (c, us) in kernels]}
    line("profile", **rec)
    return rec


def agent_env():
    """The agent phases' scenario: V100/medium/single, one month of trace
    from seed 0, history 144, a decision every 600 s; and its LANES-lane
    vector env, whose replay cache the training env shares."""
    scn = get_scenario("V100", "medium", "single")
    trace = scn.make_trace(months=1, seed=0)
    cfg = scn.env_config(history=HISTORY, interval=600.0)
    return trace, cfg, make_vector_env(trace, cfg, LANES, seed=0)


def phase_serve(venv) -> dict:
    launches = None
    for kind in ("moe", "transformer"):
        fc = FoundationConfig(kind=kind, history=HISTORY, trunk=TRUNK)
        learner = DQNLearner(fc, DQNConfig(), seed=0)
        counts, states = serve(venv, f"{kind}+dqn",
                               LearnerPolicy(f"{kind}+dqn", learner),
                               kernel_path=True)
        launches = launches or counts       # the moe+dqn run is the main path
        check_q_values(learner, states)
        profile_device(
            kind, lambda: [learner.act_batch(states, explore=False)
                           for _ in range(PROFILE_STEPS)],
            PROFILE_STEPS, "decision", lanes=len(states))
        del learner
        torch.cuda.empty_cache()
    serve(venv, "reactive", ReactivePolicy(), kernel_path=False)
    return launches


# ----------------------------------------------- 4b. agent training
def _zero_forward_counts() -> None:
    for kern in (flash_attention, grouped_gemm):
        kern.launches = kern.tc_launches = 0


def _set_train_counts() -> None:
    _zero_forward_counts()
    flash_attention_bwd.launches = flash_attention_bwd.tc_launches = 0
    grouped_gemm.bwd_launches = grouped_gemm.bwd_tc_launches = 0
    grouped_gemm.bwd_fused_calls = 0


def _check_backward_counts(what: str, trunk_passes: int) -> dict:
    """The backward launches since the counts were zeroed must be those of
    ``trunk_passes`` differentiated trunk passes: per layer one flash
    backward, GEMM_BWD_PER_LAYER GEMM backward products, all on the tensor
    cores, from one fused call per projection."""
    counts = {"flash_bwd_launches": flash_attention_bwd.launches,
              "flash_bwd_tc_launches": flash_attention_bwd.tc_launches,
              "gemm_bwd_launches": grouped_gemm.bwd_launches,
              "gemm_bwd_tc_launches": grouped_gemm.bwd_tc_launches,
              "gemm_bwd_fused_calls": grouped_gemm.bwd_fused_calls}
    layers = trunk_passes * TRUNK.n_layers
    want = (layers * FLASH_PER_LAYER, layers * GEMM_BWD_PER_LAYER,
            layers * GEMM_BWD_PER_LAYER, layers * GEMMS_PER_LAYER)
    got = (counts["flash_bwd_launches"], counts["gemm_bwd_launches"],
           counts["gemm_bwd_tc_launches"], counts["gemm_bwd_fused_calls"])
    if not trunk_passes or got != want:
        raise RuntimeError(f"{what}: {counts} for {trunk_passes} trunk "
                           f"passes, expected {want} flash backward, GEMM "
                           "backward products (tensor-core) and fused calls")
    return counts


def _finite(what: str, losses) -> list:
    losses = [float(x) for x in losses]
    if not losses or not np.isfinite(losses).all():
        raise RuntimeError(f"{what}: non-finite or no losses {losses}")
    return losses


class _Timed:
    """Wraps a learner method: host ms per call after a synchronize (the
    card's work of the call included), and its return values."""

    def __init__(self, obj, name: str):
        self.inner = getattr(obj, name)
        self.ms, self.out = [], []
        setattr(obj, name, self)

    def __call__(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.inner(*args, **kw)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.out.append(out)
        return out


def _ms(ms) -> dict:
    ms = np.asarray(ms)
    return {"mean": float(ms.mean()), "p50": float(np.percentile(ms, 50)),
            "max": float(ms.max()), "n": int(len(ms))}


def check_train_grads(learner, batch) -> None:
    """One full-width ``train_on`` step's loss and gradients with the
    kernels on the card against the same step on the CPU plain path, same
    weights and batch: every leaf within GRAD_REL_TOL of its largest
    magnitude."""
    dev = {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}
    _set_train_counts()
    loss, grads = value_and_grad(learner.loss, learner.params, dev)
    torch.cuda.synchronize()
    _check_backward_counts("gradient check", 1)
    cpu = tree_map(lambda t: t.cpu(), learner.params)
    t0 = time.perf_counter()
    ploss, pgrads = value_and_grad(
        learner.loss, cpu, {k: torch.as_tensor(v) for k, v in batch.items()})
    cpu_s = time.perf_counter() - t0
    worst, flat, pflat = 0.0, _leaves(grads), _leaves(pgrads)
    for i, (g, pg) in enumerate(zip(flat, pflat)):
        g = g.float().cpu()
        if not torch.isfinite(g).all():
            raise RuntimeError(f"gradient leaf {i} is not finite")
        scale = float(pg.abs().max())
        err = float((g - pg).abs().max())
        if err > GRAD_REL_TOL * scale:
            raise RuntimeError(f"gradient leaf {i} {tuple(g.shape)}: kernel "
                               f"path off the CPU plain path by {err} (scale "
                               f"{scale}, tolerance {GRAD_REL_TOL} of it)")
        worst = max(worst, err / scale if scale else 0.0)
    line("train", what="gradient check", batch=len(batch["a"]),
         leaves=len(flat), loss=float(loss), cpu_loss=float(ploss),
         worst_rel_err=worst, rel_tol=GRAD_REL_TOL, cpu_plain_s=cpu_s)


def phase_train(trace, cfg, venv) -> dict:
    """Pretraining, online DQN and PG at the full moe width on the serving
    scenario; raises on a non-finite loss, a backward count that is not
    the trunk's, or a gradient off the CPU plain path."""
    env = make_env(trace, cfg, seed=0, cache=venv.cache)
    fc = FoundationConfig(kind="moe", history=HISTORY, trunk=TRUNK)
    t0 = time.perf_counter()
    samples = collect_offline_samples(env, n_episodes=TRAIN_SAMPLE_EPISODES,
                                      n_points=TRAIN_SAMPLE_POINTS, seed=0)
    line("train", what="offline samples", n=len(samples),
         seconds=time.perf_counter() - t0)
    totals = defaultdict(int)

    def tally(counts):
        for k, v in counts.items():
            totals[k] += v

    # offline pretraining (§4.9.1): every step one trunk pass over 2 x 16
    # sequences (both actions), differentiated. A one-step call first warms
    # the allocator and the libraries up; the weights' draw (on the host,
    # then moved) is timed alone and taken out of the per-step time
    pretrain_foundation(fc, samples[:PRETRAIN_BATCH], epochs=1, seed=0,
                        batch_size=PRETRAIN_BATCH)
    t0 = time.perf_counter()
    init_foundation(torch.Generator().manual_seed(0), fc)
    torch.cuda.synchronize()
    init_ms = (time.perf_counter() - t0) * 1e3
    _set_train_counts()
    t0 = time.perf_counter()
    params, losses = pretrain_foundation(fc, samples, epochs=PRETRAIN_EPOCHS,
                                         seed=0, batch_size=PRETRAIN_BATCH)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps = PRETRAIN_EPOCHS * -(-len(samples) // PRETRAIN_BATCH)
    counts = _check_backward_counts("pretrain_foundation", steps)
    tally(counts)
    line("train", what="pretrain_foundation", kind="moe",
         experts=fc.n_experts, history=HISTORY, batch=PRETRAIN_BATCH,
         steps=steps, epoch_losses=_finite("pretrain", losses),
         wall_ms=wall_ms, init_ms=init_ms,
         ms_per_step=(wall_ms - init_ms) / steps, **counts)

    # online DQN (§4.9.2): 4 train_on steps per finished episode once the
    # replay holds a batch of 32; each one trunk pass over 2 x 32 sequences
    learner = DQNLearner(fc, DQNConfig(batch_size=DQN_BATCH), seed=0,
                         params=params)
    train_on = _Timed(learner, "train_on")
    _set_train_counts()
    t0 = time.perf_counter()
    returns = train_online_dqn(env, learner, episodes=DQN_EPISODES, seed=0,
                               batch=DQN_LANES)
    wall = time.perf_counter() - t0
    counts = _check_backward_counts("train_online_dqn", len(train_on.ms))
    tally(counts)
    line("train", what="train_online_dqn", episodes=len(returns),
         returns=returns, train_on_steps=len(train_on.ms),
         losses=_finite("train_on", train_on.out),
         ms_per_train_on=_ms(train_on.ms), wall_s=wall, **counts,
         flash_launches=flash_attention.launches,
         gemm_launches=grouped_gemm.launches)
    del learner.train_on                  # the method again, untimed

    # a fixed replay-shaped batch of the offline states, for the gradient
    # check and the profile
    rng = np.random.default_rng(0)
    X = np.stack([s_["matrix"] for s_ in samples]).astype(np.float32)
    ids = rng.integers(0, len(X), DQN_BATCH)
    batch = {"s": X[ids], "a": rng.integers(0, 2, DQN_BATCH),
             "r": np.array([samples[i]["reward"] for i in ids], np.float32),
             "s2": X[rng.integers(0, len(X), DQN_BATCH)],
             "done": np.zeros(DQN_BATCH, bool)}
    check_train_grads(learner, {k: v[:GRAD_CHECK_BATCH]
                                for k, v in batch.items()})
    profile_device("moe+dqn train_on", lambda: [
        learner.train_on(batch) for _ in range(PROFILE_TRAIN_STEPS)],
        PROFILE_TRAIN_STEPS, "step", batch=DQN_BATCH)

    # online PG: one update per finished episode, the episode padded to a
    # multiple of 32 decisions, every row through the trunk
    pg = PGLearner(fc, PGConfig(), seed=0, params=params)
    update = _Timed(pg, "train_on_episode")
    _set_train_counts()
    t0 = time.perf_counter()
    pg_returns = train_online_pg(env, pg, episodes=PG_EPISODES, seed=0,
                                 batch=PG_EPISODES)
    wall = time.perf_counter() - t0
    counts = _check_backward_counts("train_online_pg", len(update.ms))
    tally(counts)
    line("train", what="train_online_pg", episodes=len(pg_returns),
         returns=pg_returns, updates=len(update.ms),
         losses=_finite("train_on_episode", update.out),
         ms_per_update=_ms(update.ms), wall_s=wall, **counts)
    del pg, update

    # the trained DQN learner serves one chunk of 32 lanes
    t0 = time.perf_counter()
    res = evaluate_batch(venv, LearnerPolicy("moe+dqn", learner), seed=1)
    summary = res.summary()
    if summary["n_episodes"] != LANES:
        raise RuntimeError(f"trained learner: {summary['n_episodes']} "
                           "episodes")
    line("train", what="trained moe+dqn evaluate_batch", summary=summary,
         wall_s=time.perf_counter() - t0)
    line("train", what="backward launches, all training", **totals,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del learner, params
    torch.cuda.empty_cache()
    return {"flash_attention_bwd": totals["flash_bwd_launches"],
            "grouped_gemm_bwd": totals["gemm_bwd_fused_calls"],
            "grouped_gemm_bwd_products": totals["gemm_bwd_launches"]}


# ----------------------------------------------- 4. Mamba2-1.3B serving
def _items(tree, prefix=""):
    """(path, leaf) for every leaf of a tree of dicts and lists, in order."""
    if isinstance(tree, dict):
        return [i for k, v in tree.items() for i in _items(v, f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [i for n, v in enumerate(tree)
                for i in _items(v, f"{prefix}/{n}")]
    return [(prefix, tree)]


def _leaves(tree):
    return [t for _, t in _items(tree)]


def _counts():
    return {"rmsnorm": rmsnorm.launches, "rmsnorm_vec": rmsnorm.vec_launches,
            "ssd": ssd.launches, "ssd_tc": ssd.tc_launches}


def _set_counts(n: int = 0) -> None:
    rmsnorm.launches = rmsnorm.vec_launches = n
    ssd.launches = ssd.tc_launches = n


def _pass_counts(norms: int, scans: int) -> dict:
    """The counts of a pass of ``norms`` RMSNorm and ``scans`` SSD launches,
    every norm vectorised and every scan on the tensor cores."""
    return {"rmsnorm": norms, "rmsnorm_vec": norms, "ssd": scans,
            "ssd_tc": scans}


def _lm_inputs(gen, B, S):
    toks = torch.randint(0, LM.vocab_size, (B, S), generator=gen,
                         device="cuda")
    return toks, torch.arange(S, device="cuda").expand(B, S)


def lm_prefill_decode(params, toks, pos) -> dict:
    """One prefill of ``toks`` and LM_DECODE greedy decode steps from its
    cache, with the launch counts checked per prefill and per step."""
    prefill_step, serve_step = make_prefill_step(LM), make_serve_step(LM)
    B, S = toks.shape
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, toks, pos)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if _counts() != _pass_counts(NORMS_PER_PASS, LM.n_layers):
            raise RuntimeError(f"prefill launched {_counts()}")
        if logits.shape != (B, LM.vocab) or not torch.isfinite(logits).all():
            raise RuntimeError(f"bad prefill logits {tuple(logits.shape)}")
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        step_ms = []
        for i in range(LM_DECODE):
            before = _counts()
            t0 = time.perf_counter()
            tok, logits, cache = serve_step(params, tok, pos[:, -1:] + 1 + i,
                                            cache, S + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            after = _counts()
            if {k: after[k] - before[k] for k in after} != \
                    _pass_counts(NORMS_PER_PASS, 0):
                raise RuntimeError(f"decode step {i}: {before} -> {after}")
        if not torch.isfinite(logits).all():
            raise RuntimeError("non-finite decode logits")
    ms = np.asarray(step_ms)
    return {"prefill_ms": prefill_ms,
            "prefill_tokens_per_s": B * S / prefill_ms * 1e3,
            "decode_ms_mean": float(ms.mean()),
            "decode_ms_p50": float(np.percentile(ms, 50)),
            "decode_ms_p99": float(np.percentile(ms, 99)),
            "decode_tokens_per_s": B / ms.mean() * 1e3,
            "state_shape": list(cache["segments"][0]["b0"]["state"].shape)}


def check_lm_plain(params, toks) -> None:
    """The first LM_PLAIN_LAYERS layers of the full-width model, same
    weights, prefill of one LM_PLAIN_PROMPT-token prompt: kernel path on the
    card against the plain path on the CPU, last-token logits and final SSM
    states."""
    cfg = LM.replace(n_layers=LM_PLAIN_LAYERS)
    sub = dict(params, segments=[{"b0": tree_map(
        lambda t: t[:LM_PLAIN_LAYERS], params["segments"][0]["b0"])}])
    x = toks[:1, :LM_PLAIN_PROMPT]
    pos = torch.arange(LM_PLAIN_PROMPT, device="cuda")[None]
    with torch.inference_mode():
        _set_counts()
        lg, cache = transformer.prefill(sub, cfg, x, pos)
        torch.cuda.synchronize()
        if _counts() != _pass_counts(2 * LM_PLAIN_LAYERS + 1,
                                     LM_PLAIN_LAYERS):
            raise RuntimeError(f"2-layer prefill launched {_counts()}")
        t0 = time.perf_counter()
        lg_cpu, cache_cpu = transformer.prefill(
            tree_map(lambda t: t.cpu(), sub), cfg, x.cpu(), pos.cpu())
        cpu_s = time.perf_counter() - t0
    state, state_cpu = (c["segments"][0]["b0"]["state"]
                        for c in (cache, cache_cpu))
    line("lm_plain", layers=LM_PLAIN_LAYERS, prompt=LM_PLAIN_PROMPT,
         logits_max_abs_err=_rel_err(lg, lg_cpu, "logits"),
         logits_scale=lg_cpu.abs().max().item(),
         state_max_abs_err=_rel_err(state, state_cpu, "final states"),
         state_scale=state_cpu.abs().max().item(), rel_tol=LM_REL_TOL,
         cpu_plain_s=cpu_s)


def phase_lm() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = transformer.init(gen, LM)
    torch.cuda.synchronize()
    leaves = _leaves(params)
    line("lm_init", arch=LM.arch_id, layers=LM.n_layers, d_model=LM.d_model,
         d_inner=LM.d_inner, heads=LM.ssm_nheads, state=LM.ssm_state,
         vocab=LM.vocab, params=sum(t.numel() for t in leaves),
         param_gb=sum(t.numel() * t.element_size() for t in leaves) / 1e9,
         seconds=time.perf_counter() - t0)
    toks, pos = _lm_inputs(gen, LM_BATCH, LM_PROMPT)
    with torch.inference_mode():      # warm-up: cuBLAS handles, libraries
        lg, cache = make_prefill_step(LM)(params, toks[:, :LM.ssm_chunk],
                                          pos[:, :LM.ssm_chunk])
        make_serve_step(LM)(params, lg.argmax(-1, keepdim=True).to(torch.int32),
                            pos[:, :1] + LM.ssm_chunk, cache, LM.ssm_chunk)
    torch.cuda.synchronize()
    del lg, cache

    _set_counts()                     # the LM's main path
    res = lm_prefill_decode(params, toks, pos)
    launches = _counts()
    line("lm_serve", batch=LM_BATCH, prompt=LM_PROMPT,
         decode_steps=LM_DECODE, launches=launches,
         ssd_per_prefill=LM.n_layers, rmsnorm_per_pass=NORMS_PER_PASS, **res)

    check_lm_plain(params, toks)

    # one prefill, then 5 decode steps from its cache, each profiled alone
    prefill_step, serve_step = make_prefill_step(LM), make_serve_step(LM)
    with torch.inference_mode():
        lg, cache = prefill_step(params, toks, pos)
    tok0 = lg.argmax(-1, keepdim=True).to(torch.int32)

    def decode(n):
        with torch.inference_mode():
            tok, c = tok0, cache
            for i in range(n):
                tok, _, c = serve_step(params, tok, pos[:, -1:] + 1 + i, c,
                                       LM_PROMPT + i)
    with torch.inference_mode():
        profile_device("mamba2 prefill",
                       lambda: prefill_step(params, toks, pos), 1, "prefill",
                       batch=LM_BATCH, prompt=LM_PROMPT)
    profile_device("mamba2 decode", lambda: decode(PROFILE_STEPS),
                   PROFILE_STEPS, "step", batch=LM_BATCH)
    del params, cache
    torch.cuda.empty_cache()

    _set_counts()
    out = serve_launcher.main(["--arch", LM.arch_id])
    counts = _counts()
    if out["done"] != out["requests"]:
        raise RuntimeError(f"engine finished {out['done']} of "
                           f"{out['requests']} requests")
    if counts["ssd"] or not counts["rmsnorm"] \
            or counts["rmsnorm"] % NORMS_PER_PASS:
        raise RuntimeError(f"engine launched {counts}")
    line("engine", **out, launches=counts,
         decode_calls=counts["rmsnorm"] // NORMS_PER_PASS)
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------- 6. the Fig-8 grid on the card
def _forward_counts() -> dict:
    return {"flash_launches": flash_attention.launches,
            "flash_tc_launches": flash_attention.tc_launches,
            "gemm_launches": grouped_gemm.launches,
            "gemm_tc_launches": grouped_gemm.tc_launches}


def _all_on_tensor_cores(what: str) -> dict:
    """Every flash and GEMM launch since the counts were zeroed, forward
    and backward, ran the tensor-core variant, and each kernel launched."""
    counts = {**_forward_counts(),
              "flash_bwd_launches": flash_attention_bwd.launches,
              "flash_bwd_tc_launches": flash_attention_bwd.tc_launches,
              "gemm_bwd_launches": grouped_gemm.bwd_launches,
              "gemm_bwd_tc_launches": grouped_gemm.bwd_tc_launches}
    pairs = [(counts[k], counts[k.replace("launches", "tc_launches")])
             for k in counts if "tc" not in k]
    counts["gemm_bwd_fused_calls"] = grouped_gemm.bwd_fused_calls
    if any(n == 0 or n != tc for n, tc in pairs):
        raise RuntimeError(f"{what}: launches off the tensor cores or "
                           f"missing: {counts}")
    return counts


def _check_summary(what: str, res) -> dict:
    summary = res.summary()
    if not all(np.isfinite(float(v)) for v in summary.values()) or \
            res.fallbacks != 0:
        raise RuntimeError(f"{what}: {summary}, {res.fallbacks} fallbacks")
    return summary


def phase_grid() -> tuple:
    """One cluster's Fig-8 grid on torch learners at the agent's full
    width, as ``benchmarks/bench_interruption.py:run_grid`` runs it at its
    QUICK scale; then cross-tenant training. Returns the trained policies
    and the launches of the phase."""
    _set_train_counts()
    cells = [sc.with_chain_nodes(1) for sc in
             iter_scenarios(clusters=[GRID_CLUSTER], chains=["single"])]
    env_kw = dict(months=GRID_MONTHS, history=HISTORY, interval=INTERVAL)
    env_train = next(sc for sc in cells if sc.load == "heavy"
                     and not sc.fault).make_env(seed=100, **env_kw)
    t0 = time.perf_counter()
    samples = []
    for li, sc in enumerate(c for c in cells if not c.fault):
        samples += collect_offline_samples(
            sc.make_env(seed=100 + li, **env_kw),
            n_episodes=max(GRID_OFFLINE_EPISODES // len(LOAD_LEVELS), 1),
            n_points=5, seed=1 + li)
    line("grid", what="offline samples", n=len(samples),
         seconds=time.perf_counter() - t0)
    policies = {}
    for m in ALL_METHODS:
        t0 = time.perf_counter()
        policies[m] = build_policy(
            m, env_train, offline_samples=samples,
            online_episodes=GRID_ONLINE_EPISODES,
            pretrain_epochs=GRID_PRETRAIN_EPOCHS, history=HISTORY,
            reduced=False, seed=0)
        torch.cuda.synchronize()
        line("grid", what="train", method=m,
             train_wall_s=time.perf_counter() - t0)
    for sc in cells:
        venv = sc.make_vector_env(GRID_EVAL_LANES, seed=200, **env_kw)
        key = sc.load + (f"/{sc.fault}" if sc.fault else "")
        t_cell = time.perf_counter()
        for m in ALL_METHODS:
            t0 = time.perf_counter()
            res = evaluate_batch(venv, policies[m], seed=7)
            line("grid", cell=key, method=m,
                 summary=_check_summary(f"{key} {m}", res),
                 eval_wall_s=time.perf_counter() - t0)
        line("grid", what="cell", cell=key,
             eval_wall_s=time.perf_counter() - t_cell)
    grid = _all_on_tensor_cores("grid")
    line("grid", what="launches, training and evaluation", **grid)

    # cross-tenant training: 2 co-sim groups of 8 chains contending for
    # one simulated cluster each, a fresh learner at the full moe width
    fc = FoundationConfig(kind="moe", history=HISTORY, trunk=TRUNK)
    learner = DQNLearner(fc, DQNConfig(), seed=0)
    train_on = _Timed(learner, "train_on")
    _set_train_counts()
    t0 = time.perf_counter()
    returns = train_online_dqn(env_train, learner, episodes=CO_EPISODES,
                               seed=0, tenants=CO_TENANTS)
    wall = time.perf_counter() - t0
    co = _check_backward_counts("cross-tenant train_online_dqn",
                                len(train_on.ms))
    co.update(_all_on_tensor_cores("cross-tenant train_online_dqn"))
    if len(returns) != CO_EPISODES or not np.isfinite(returns).all():
        raise RuntimeError(f"cross-tenant returns {returns}")
    line("grid", what="cross-tenant train_online_dqn", tenants=CO_TENANTS,
         groups=CO_EPISODES // CO_TENANTS, returns=returns,
         train_on_steps=len(train_on.ms),
         losses=_finite("train_on", train_on.out),
         ms_per_train_on=_ms(train_on.ms), wall_s=wall, **co)
    del learner, train_on
    torch.cuda.empty_cache()
    launches = {"flash_attention": grid["flash_launches"]
                + co["flash_launches"],
                "grouped_gemm": grid["gemm_launches"] + co["gemm_launches"],
                "flash_attention_bwd": grid["flash_bwd_launches"]
                + co["flash_bwd_launches"],
                "grouped_gemm_bwd": grid["gemm_bwd_fused_calls"]
                + co["gemm_bwd_fused_calls"],
                "grouped_gemm_bwd_products": grid["gemm_bwd_launches"]
                + co["gemm_bwd_launches"]}
    return policies, launches


# ------------------------------------------------ 7. the provisioning service
class Kill(BaseException):
    """Abrupt death of the serving process: not an ``Exception``, so the
    service's ``FallbackPolicy`` cannot turn it into reactive decisions."""


class Served(Policy):
    """The learner's policy as the service consults it: records each
    batch's size, keeps the first full batch's states, and raises ``Kill``
    once ``kill_after`` batches were answered."""

    def __init__(self, inner, kill_after=None):
        self.inner, self.method = inner, inner.method
        self.sizes = []
        self.kill_after = kill_after

    def act_batch(self, obs):
        if self.kill_after is not None and len(self.sizes) >= self.kill_after:
            raise Kill()
        self.sizes.append(len(obs["matrix"]))
        return self.inner.act_batch(obs)


def service_world():
    """``benchmarks/bench_serve.py``'s world at the agent's history: a month
    of V100 trace (seed 5) under the faulty plan (seed 3), 6-hour
    sub-jobs, a decision every 600 s over the last 144 snapshots."""
    v100 = PROFILES["V100"]
    jobs = synthesize_trace(v100, months=1, seed=5, load_scale=1.0)
    plan = get_fault_spec("faulty").make_plan(
        jobs[-1].submit_time + 3 * DAY, v100.n_nodes, seed=3)
    cfg = EnvConfig(n_nodes=v100.n_nodes, history=HISTORY, interval=INTERVAL,
                    sub_limit=SERVICE_SUB_LIMIT, faults=plan)
    return jobs, cfg, ReplayCheckpointCache(jobs, cfg.n_nodes, faults=plan)


def _retry(i):
    return RetryPolicy(seed=100 + i, sleep=lambda _s: None)


def _service(world, policy, tenants, links, co_sim=False, journal_dir=None,
             breaker=None):
    jobs, cfg, cache = world
    return ProvisionService(
        jobs, cfg, policy, svc=ServiceConfig(
            tenants=tenants, links=links, max_batch=SERVICE_MAX_BATCH,
            co_sim=co_sim), seed=SERVICE_SEED, journal_dir=journal_dir,
        cache=cache, breaker=breaker, retry_factory=_retry)


def _check_learner_run(what: str, res, policy, live_batches: int,
                       reason: str = "completed") -> dict:
    """The learner answered every decision (no fallback, no degraded
    answer, no breaker trip, no shed, no deadline), and every live batch
    launched 4 flash and 24 GEMM kernels on the tensor cores."""
    counts = _forward_counts()
    layers = live_batches * TRUNK.n_layers
    bad = []
    if res.reason != reason:
        bad.append(f"reason {res.reason}")
    for k in ("n_degraded", "breaker_trips", "n_shed"):
        if getattr(res, k, 0):
            bad.append(f"{k} {getattr(res, k)}")
    if policy.n_fallbacks or policy.deadline_s is not None:
        bad.append(f"{policy.n_fallbacks} fallbacks, deadline "
                   f"{policy.deadline_s}")
    if not live_batches or \
            (counts["flash_launches"], counts["gemm_launches"]) != \
            (layers * FLASH_PER_LAYER, layers * GEMMS_PER_LAYER) or \
            counts["flash_tc_launches"] != counts["flash_launches"] or \
            counts["gemm_tc_launches"] != counts["gemm_launches"]:
        bad.append(f"launches {counts} for {live_batches} batches")
    if bad:
        raise RuntimeError(f"{what}: " + "; ".join(bad))
    return counts


def _serve_measured(what, world, learner_policy, tenants, co_sim=False):
    """One journal-less learner run of the service: decisions/s, latency
    quantiles, rounds, batches, the batch-size histogram, launches."""
    served = Served(learner_policy)
    svc = _service(world, served, tenants, 1, co_sim=co_sim)
    _zero_forward_counts()
    t0 = time.perf_counter()
    res = svc.run()
    wall = time.perf_counter() - t0
    counts = _check_learner_run(what, res, svc.policy, res.n_batches)
    hist = Counter(served.sizes)
    line("service", what=what, tenants=tenants, links=1, co_sim=co_sim,
         max_batch=SERVICE_MAX_BATCH, decisions=res.n_decisions,
         decisions_per_s=res.n_decisions / wall,
         latency_ms_p50=res.latency_quantile(0.5) * 1e3,
         latency_ms_p99=res.p99_latency_s * 1e3,
         rounds=res.n_rounds, batches=res.n_batches,
         batch_sizes={str(k): hist[k] for k in sorted(hist)},
         wall_s=wall, n_degraded=res.n_degraded,
         breaker_trips=res.breaker_trips,
         n_fallbacks=svc.policy.n_fallbacks, **counts)
    return res, wall, counts


def _kill_and_resume(what, run):
    """``run(kill_after)`` uninterrupted, then killed after half its policy
    calls, then again on the killed run's journal: the resumed run must
    replay what the killed one applied and end with the uninterrupted
    run's schedules."""
    ref = run(None, "ref")
    try:
        run(max(1, ref["calls"] // 2), "run")
    except Kill:
        pass
    else:
        raise RuntimeError(f"{what}: the run was not killed")
    resumed = run(None, "run")
    if resumed["schedules"] != ref["schedules"] or not resumed["replayed"] \
            or resumed["replayed"] + resumed["live"] != ref["live"]:
        raise RuntimeError(f"{what}: the resumed run ({resumed['replayed']} "
                           f"replayed, {resumed['live']} live) differs from "
                           f"the uninterrupted one ({ref['live']})")
    line("service", what=what, decisions=ref["live"],
         replayed=resumed["replayed"], resumed_live=resumed["live"],
         schedules_equal=True, **resumed["counts"])


def phase_service(policies) -> dict:
    """``ProvisionService`` and ``ChainDriver`` serving the grid's moe+dqn
    learner; raises unless every learner run decided with the learner alone,
    on the tensor cores, and the killed runs resume to their uninterrupted
    schedules."""
    world = service_world()
    learner_policy = policies["moe+dqn"]
    totals = defaultdict(int)

    def tally():
        for k in ("flash_launches", "gemm_launches"):
            totals[k] += _forward_counts()[k]

    # (a) 128 solo tenants, one fork each
    res, wall, _ = _serve_measured("solo", world, learner_policy,
                                   SERVICE_TENANTS)
    tally()
    # the same fleet with the breaker forced open: every decision reactive,
    # the loop's host-only cost
    breaker = CircuitBreaker(cooldown_s=float("inf"))
    breaker.trip()
    svc = _service(world, Served(learner_policy), SERVICE_TENANTS, 1,
                   breaker=breaker)
    _zero_forward_counts()
    t0 = time.perf_counter()
    dres = svc.run()
    dwall = time.perf_counter() - t0
    if dres.n_degraded != dres.n_decisions or flash_attention.launches:
        raise RuntimeError(f"breaker open: {dres.n_degraded} of "
                           f"{dres.n_decisions} degraded, "
                           f"{flash_attention.launches} flash launches")
    line("service", what="solo, breaker forced open", tenants=SERVICE_TENANTS,
         decisions=dres.n_decisions, decisions_per_s=dres.n_decisions / dwall,
         learner_decisions_per_s=res.n_decisions / wall, wall_s=dwall)

    # (b) 1024 tenants contending in one shared simulator
    _serve_measured("co-sim", world, learner_policy, SERVICE_CO_TENANTS,
                    co_sim=True)
    tally()

    # (c) 8 tenants x 2 links, journaled, killed and resumed
    jroot = Path(__file__).resolve().parent / "build" / "smoke_journals"
    shutil.rmtree(jroot, ignore_errors=True)
    jroot.mkdir(parents=True)

    def service_run(kill_after, journal):
        served = Served(learner_policy, kill_after)
        svc = _service(world, served, JOURNAL_TENANTS, 2,
                       journal_dir=str(jroot / f"service_{journal}"))
        _zero_forward_counts()
        try:
            res = svc.run()
        finally:                      # a killed run's launches count too
            tally()
        counts = _check_learner_run("journaled service", res, svc.policy,
                                    res.n_batches)
        return {"schedules": [t.schedule for t in res.tenants],
                "replayed": res.n_replayed, "live": res.n_decisions,
                "calls": len(served.sizes), "counts": counts}

    _kill_and_resume("journaled service, killed and resumed", service_run)

    # (d) a 2-link chain driver, journaled, killed and resumed
    jobs, cfg, cache = world

    def chain_run(kill_after, journal):
        served = Served(learner_policy, kill_after)
        driver = ChainDriver(jobs, cfg, served, links=2, seed=SERVICE_SEED,
                             journal=DecisionJournal(
                                 str(jroot / f"chain_{journal}.journal")),
                             retry=_retry(0), cache=cache)
        _zero_forward_counts()
        try:
            res = driver.run()
        finally:
            tally()
        live = res.n_decisions - res.n_replayed
        counts = _check_learner_run("chain driver", res, driver.policy, live)
        if res.n_fallbacks:
            raise RuntimeError(f"chain driver: {res.n_fallbacks} fallbacks")
        return {"schedules": res.schedule, "replayed": res.n_replayed,
                "live": live, "calls": len(served.sizes), "counts": counts}

    _kill_and_resume("chain driver, killed and resumed", chain_run)
    shutil.rmtree(jroot, ignore_errors=True)

    # one full 64-lane service batch under the profiler: stacking the
    # lanes' observations, the decision and applying 64 decisions to their
    # lanes (no journal); then the decision alone on the same 64 states
    svc = _service(world, learner_policy, SERVICE_TENANTS, 1)
    svc.start()
    svc._serve_chunk(list(range(SERVICE_MAX_BATCH)))           # warm-up
    chunk = list(range(SERVICE_MAX_BATCH, 2 * SERVICE_MAX_BATCH))
    states = np.array(stack_obs([svc.lanes[i].obs for i in chunk])["matrix"],
                      np.float32)
    profile_device("service batch", lambda: svc._serve_chunk(chunk), 1,
                   "batch", warmup=0, lanes=SERVICE_MAX_BATCH)
    learner = learner_policy.learner
    profile_device("moe decision, service width", lambda: [
        learner.act_batch(states, explore=False)
        for _ in range(PROFILE_STEPS)], PROFILE_STEPS, "decision",
        lanes=SERVICE_MAX_BATCH)
    return {"flash_attention": totals["flash_launches"],
            "grouped_gemm": totals["gemm_launches"]}


# -------------------------------------------- 8. Mamba2-1.3B training
def _set_lm_train_counts() -> None:
    _set_counts()
    rmsnorm.bwd_launches = rmsnorm.bwd_vec_launches = 0
    ssd.bwd_launches = ssd.bwd_tc_launches = 0


def _lm_train_counts() -> dict:
    return dict(_counts(), rmsnorm_bwd=rmsnorm.bwd_launches,
                rmsnorm_bwd_vec=rmsnorm.bwd_vec_launches,
                ssd_bwd=ssd.bwd_launches, ssd_bwd_tc=ssd.bwd_tc_launches)


def _check_lm_train_counts(what: str, passes: int) -> dict:
    """The launches since the counts were zeroed must be those of
    ``passes`` differentiated micro-batch passes: NORMS_PER_PASS RMSNorm and
    n_layers SSD launches, forward and backward, every norm vectorised and
    every scan on the tensor cores, both ways."""
    got = _lm_train_counts()
    norms, scans = passes * NORMS_PER_PASS, passes * LM.n_layers
    want = dict(_pass_counts(norms, scans), rmsnorm_bwd=norms,
                rmsnorm_bwd_vec=norms, ssd_bwd=scans, ssd_bwd_tc=scans)
    if not passes or got != want:
        raise RuntimeError(f"{what}: launched {got}, expected {want}")
    return got


def lm_train_run(params, opt, what, batch, seq, steps, microbatches=1):
    """``steps`` train steps of ``make_train_step`` at the launcher's
    optimizer on ``data_iterator`` batches, after one warm-up step whose
    result is dropped; host ms per step after ``synchronize``."""
    step_fn = make_train_step(LM, TRAIN_OCFG, microbatches)
    data = data_iterator(LM, DataConfig(batch=batch, seq_len=seq),
                         device="cuda")
    step_fn(params, opt, next(data))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _set_lm_train_counts()
    ms, losses = [], []
    for _ in range(steps):
        b = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    counts = _check_lm_train_counts(what, steps * microbatches)
    line("lm_train", run=what, batch=batch, seq=seq, steps=steps,
         microbatches=microbatches, ms_per_step=_ms(ms),
         tokens_per_s=batch * seq / np.mean(ms) * 1e3,
         losses=_finite(what, losses),
         grad_norm=float(metrics["grad_norm"]), lr=float(metrics["lr"]),
         peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    return params, opt, counts


def _lm_grad_sub(params):
    """The first LM_PLAIN_LAYERS layers of the model, same weights."""
    cfg = LM.replace(n_layers=LM_PLAIN_LAYERS)
    sub = dict(params, segments=[{"b0": tree_map(
        lambda t: t[:LM_PLAIN_LAYERS], params["segments"][0]["b0"])}])
    return cfg, sub


def _lm_grads(cfg, sub, batch):
    """``loss_fn``'s value and gradient on ``batch``, and the launches."""
    def loss(p, b):
        return transformer.loss_fn(p, cfg, b)
    _set_lm_train_counts()
    (lval, _), grads = value_and_grad_aux(loss, sub, batch, has_aux=True)
    torch.cuda.synchronize()
    return float(lval), grads, _lm_train_counts()


def _grad_errs(grads, pgrads) -> dict:
    """Each leaf's largest error over the reference leaf's largest
    magnitude, every leaf within LM_REL_TOL of it."""
    errs = {}
    for (path, g), pg in zip(_items(grads), _leaves(pgrads)):
        _rel_err(g, pg, f"gradient {path} {tuple(g.shape)}")
        scale = float(pg.abs().max())
        errs[path] = (float((g.float().cpu() - pg.float()).abs().max())
                      / scale if scale else 0.0)
    return errs


def _cpu_inputs(sub, batch):
    return (tree_map(lambda t: t.cpu(), sub),
            {k: v.cpu() for k, v in batch.items()})


def check_lm_train_grads(params) -> None:
    """The first 2 layers of the full-width model, same weights, one
    1 x LM_GRAD_SEQ batch (two chunks): ``loss_fn``'s gradient with the
    kernels on the card against the plain path on the CPU, every leaf
    within LM_REL_TOL of its largest magnitude."""
    cfg, sub = _lm_grad_sub(params)
    batch = synth_batch(cfg, DataConfig(batch=1, seq_len=LM_GRAD_SEQ), 0,
                        device="cuda")
    lval, grads, got = _lm_grads(cfg, sub, batch)
    norms = 2 * LM_PLAIN_LAYERS + 1
    if (got["rmsnorm_bwd"], got["rmsnorm_bwd_vec"], got["ssd_bwd"],
            got["ssd_bwd_tc"]) != (norms, norms, LM_PLAIN_LAYERS,
                                   LM_PLAIN_LAYERS):
        raise RuntimeError(f"2-layer gradient launched {got}")
    t0 = time.perf_counter()
    pval, pgrads, _ = _lm_grads(cfg, *_cpu_inputs(sub, batch))
    cpu_s = time.perf_counter() - t0
    errs = _grad_errs(grads, pgrads)
    worst = max(errs, key=errs.get)
    line("lm_train", run="2-layer gradient check", layers=LM_PLAIN_LAYERS,
         seq=LM_GRAD_SEQ, leaves=len(errs), loss=lval, cpu_loss=pval,
         worst_rel_err=errs[worst], worst_leaf=worst, rel_tol=LM_REL_TOL,
         cpu_plain_s=cpu_s)


def lm_grad_rounding(params, seeds=(0, 1, 2)) -> None:
    """What the tensor-core SSD backward's bf16 roundings do to the 2-layer
    gradient check: for each batch seed, the check's leaf errors against
    one CPU reference with the scan's backward on "tc" (as training runs
    it), on "simt" (fp32 products) and, as "simt_all", with the RMSNorm
    backward on "simt" too (the backward kernels before the fast
    variants); the variants are forced, every other kernel runs as in
    training. Prints conv_C_w's errors (the leaf dC feeds), the worst leaf
    of each, and on how many leaves tc's error is above simt's."""
    cfg, sub = _lm_grad_sub(params)
    choose_ssd = ssd_ops._ssd_bwd_variant
    choose_norm = norm_ops._rmsnorm_bwd_variant
    arms = {"tc": ("tc", "vec"), "simt": ("simt", "vec"),
            "simt_all": ("simt", "simt")}
    for seed in seeds:
        batch = synth_batch(cfg, DataConfig(batch=1, seq_len=LM_GRAD_SEQ),
                            seed, device="cuda")
        _, pgrads, _ = _lm_grads(cfg, *_cpu_inputs(sub, batch))
        row, all_errs = {"seed": seed}, {}
        for arm, (scan, norm) in arms.items():
            ssd_ops._ssd_bwd_variant = lambda *a, v=scan: v
            norm_ops._rmsnorm_bwd_variant = lambda *a, v=norm: v
            try:
                _, grads, got = _lm_grads(cfg, sub, batch)
            finally:
                ssd_ops._ssd_bwd_variant = choose_ssd
                norm_ops._rmsnorm_bwd_variant = choose_norm
            if (got["ssd_bwd_tc"], got["rmsnorm_bwd_vec"] > 0) != (
                    LM_PLAIN_LAYERS * (scan == "tc"), norm == "vec"):
                raise RuntimeError(f"rounding study ({arm}) launched {got}")
            errs = all_errs[arm] = _grad_errs(grads, pgrads)
            worst = max(errs, key=errs.get)
            row[arm] = {"conv_C_w": {p: e for p, e in errs.items()
                                     if p.endswith("conv_C_w")},
                        "worst_leaf": worst, "worst_rel_err": errs[worst]}
        row["leaves_tc_above_simt"] = sum(
            all_errs["tc"][p] > all_errs["simt"][p] for p in all_errs["tc"])
        row["leaves"] = len(all_errs["tc"])
        line("lm_train", run="2-layer gradient, tc vs simt roundings", **row)


_KERNEL_GROUPS = (   # device-time groups of the training step's profile
    ("ssd_bwd", ("chunk_state_kernel", "chunk_state_tc_kernel",
                 "state_scan_kernel", "chunk_grad_kernel",
                 "chunk_grad_tc_kernel", "group_sum_kernel",
                 "head_sum_kernel")),
    ("ssd_fwd", ("ssd_tc_kernel", "ssd_kernel")),
    ("rmsnorm_bwd", ("rmsnorm_bwd_kernel", "rmsnorm_bwd_vec_kernel",
                     "dw_sum_kernel", "dw_tree_sum_kernel")),
    ("rmsnorm_fwd", ("rmsnorm_kernel", "rmsnorm_vec_kernel")),
    ("cublas", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
)


def _group_ms(rec: dict) -> dict:
    """Device ms per step of each _KERNEL_GROUPS group in a profile record,
    the rest as "other"."""
    out = defaultdict(float)
    for k in rec["kernels"]:
        name = k["name"]
        group = next((g for g, keys in _KERNEL_GROUPS
                      if any(key in name for key in keys)), "other")
        out[group] += k["ms_per_step"]
    return dict(out)


def profile_lm_train_step(params, opt, batch, seq) -> None:
    """One train step of run (b) under torch.profiler, its device time
    split by kernel group; AdamW's device time apart, from a profile of
    ``adamw_update`` alone on that step's gradients (the rest of "other"
    is the model's elementwise work and the loss)."""
    step_fn = make_train_step(LM, TRAIN_OCFG)
    b = synth_batch(LM, DataConfig(batch=batch, seq_len=seq), 100,
                    device="cuda")
    rec = profile_device("mamba2 train step (b)",
                         lambda: step_fn(params, opt, b), 1, "step",
                         batch=batch, seq=seq)
    groups = _group_ms(rec)
    (_, _), grads = value_and_grad_aux(
        lambda p, bb: transformer.loss_fn(p, LM, bb), params, b,
        has_aux=True)
    adam = profile_device("adamw_update (b)", lambda: adamw_update(
        grads, params, opt, TRAIN_OCFG), 1, "step", warmup=1)
    del grads
    groups["adamw"] = adam["device_ms_per_step"]
    groups["other_elementwise"] = groups.pop("other", 0.0) - groups["adamw"]
    line("lm_train", run="profile of one (b) step",
         device_busy_share=rec["device_busy_share"],
         wall_ms=rec["wall_ms_per_step"],
         device_ms=rec["device_ms_per_step"], device_ms_by_group=groups,
         adamw_busy_share=adam["device_busy_share"])


def check_train_launcher() -> None:
    """``repro_torch.launch.train --smoke`` on the card: 3 steps, then 3
    more resumed from its checkpoint ("resumed at step 3"), their losses
    equal to an uninterrupted 6-step run's within 1e-5 relative (the
    embedding's gradient sums with atomics); then ``launch.serve --smoke
    --ckpt-dir`` serves from the checkpoint."""
    split, whole = TRAIN_DIR / "split", TRAIN_DIR / "whole"
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    common = ["--arch", LM.arch_id, "--smoke"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        first = train_launcher.main(common + ["--steps", "3", "--ckpt-dir",
                                              str(split)])
        second = train_launcher.main(common + ["--steps", "3", "--ckpt-dir",
                                               str(split)])
        ref = train_launcher.main(common + ["--steps", "6", "--ckpt-dir",
                                            str(whole)])
        served = serve_launcher.main(common + ["--requests", "2",
                                               "--max-new", "4",
                                               "--ckpt-dir", str(split)])
    out = buf.getvalue()
    print(out, end="", flush=True)
    losses = first["losses"] + second["losses"]
    if "resumed at step 3" not in out or second["steps_done"] != 6:
        raise RuntimeError("the train launcher did not resume at step 3")
    if len(losses) != 6 or not np.isfinite(losses).all():
        raise RuntimeError(f"launcher losses {losses}")
    rel = np.abs(np.array(losses) - ref["losses"]) / np.abs(ref["losses"])
    if rel.max() > 1e-5:
        raise RuntimeError(f"resumed losses {losses} differ from the "
                           f"uninterrupted run's {ref['losses']}")
    if "restored weights from step 6" not in out or \
            served["done"] != served["requests"]:
        raise RuntimeError("launch.serve did not serve from the checkpoint")
    line("lm_train", run="launcher --smoke, resumed", losses=losses,
         uninterrupted=ref["losses"], max_rel_diff=float(rel.max()),
         served=served["done"], outputs=served["outputs"])
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)


def phase_lm_train() -> dict:
    """Mamba2-1.3B training at full width with seeded weights drawn on the
    card: runs (a) and (b), one micro-batched step (c), the 2-layer
    gradient check, a profiled step and the launcher at ``--smoke``.
    Returns the launches of (a), (b) and (c)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = transformer.init(gen, LM)
    opt = init_opt_state(params, TRAIN_OCFG)
    totals = defaultdict(int)
    for what, batch, seq, steps in LM_TRAIN_RUNS:
        params, opt, counts = lm_train_run(params, opt, what, batch, seq,
                                           steps)
        for k, v in counts.items():
            totals[k] += v
    # (c): one step of (a) in two micro-batches, against the same step in one
    b = synth_batch(LM, DataConfig(batch=8, seq_len=128), 50, device="cuda")
    one = make_train_step(LM, TRAIN_OCFG)(params, opt, b)[2]
    _set_lm_train_counts()
    two = make_train_step(LM, TRAIN_OCFG, 2)(params, opt, b)[2]
    torch.cuda.synchronize()
    counts = _check_lm_train_counts("(c)", 2)
    for k, v in counts.items():
        totals[k] += v
    rel = abs(float(two["loss"]) - float(one["loss"])) / abs(float(
        one["loss"]))
    if not np.isfinite(float(two["loss"])) or rel > BF16_TOL:
        raise RuntimeError(f"(c): micro-batched loss {float(two['loss'])} "
                           f"against {float(one['loss'])}")
    # the loss is a forward value: the gradient's norm is what shows the
    # accumulation over micro-batches
    grad_rel = abs(float(two["grad_norm"]) - float(one["grad_norm"])) / abs(
        float(one["grad_norm"]))
    if not np.isfinite(float(two["grad_norm"])) or grad_rel > BF16_TOL:
        raise RuntimeError(f"(c): micro-batched grad_norm "
                           f"{float(two['grad_norm'])} against "
                           f"{float(one['grad_norm'])}")
    line("lm_train", run="c", batch=8, seq=128, microbatches=2,
         loss=float(two["loss"]), single_batch_loss=float(one["loss"]),
         rel_diff=rel, rel_tol=BF16_TOL,
         grad_norm=float(two["grad_norm"]),
         single_batch_grad_norm=float(one["grad_norm"]),
         grad_norm_rel_diff=grad_rel, launches=counts)
    del one, two
    check_lm_train_grads(params)
    lm_grad_rounding(params)
    profile_lm_train_step(params, opt, *LM_TRAIN_RUNS[1][1:3])
    del params, opt
    torch.cuda.empty_cache()
    check_train_launcher()
    torch.cuda.empty_cache()
    return dict(totals)


# ------------------------------------------------------------ 5. timing
def time_ms(fn, reps=20, warmup=3, flush=True, lead=True) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, one event pair
    around each. With ``flush`` a 256 MB buffer is written before each call
    (outside its events), so every call finds the 50 MB L2 cold, as a
    serving step does its inputs; without it the calls run back to back
    and a repeat may find its inputs still cached. The card first sleeps
    for ``HOST_LEAD_CYCLES``, while the host queues every call: an event
    pair then brackets the kernel's device time alone, not a wait for the
    host to launch it (a wrapper's host cost is tens of microseconds,
    as long as a short kernel). Without ``lead`` the host queues each call
    as the card runs the one before, and a pair may hold host gaps."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, device="cuda") if flush else None
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda.synchronize()
    if lead:
        torch.cuda._sleep(HOST_LEAD_CYCLES)
    for start, end in pairs:
        if flush:
            buf.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s_.elapsed_time(e) for s_, e in pairs) / reps


def timed_variant(kernel, fn, **kw):
    """``time_ms(fn)`` and the variant that its launches of ``kernel`` ran,
    read from the kernel's counters."""
    fast, n_fast = _fast(kernel)
    n = kernel.launches
    ms = time_ms(fn, **kw)
    n, n_fast = kernel.launches - n, _fast(kernel)[1] - n_fast
    if not n:
        raise RuntimeError(f"{kernel.__name__}: the timed calls launched nothing")
    return ms, (fast if n_fast == n else "simt" if not n_fast else "mixed")


def host_us(fn, reps=50) -> float:
    """Host wall time per call of ``fn`` in microseconds, while the card
    sleeps, so that no call waits for a queue slot."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOST_LEAD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def bound_ms(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flop_rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ssd_work(Bz, S, H, P, N, G, chunk, itemsize):
    """Bytes and products the scan needs: x, dt, B, C read once, y and the
    fp32 final state written once; per chunk of q rows, C.B^T once per
    group over the causal triangle, and per head the masked scores times x
    (triangle), C times the state and the state update."""
    Q = min(chunk, S)
    flops = 0
    for s0 in range(0, S, Q):
        q = min(Q, S - s0)
        tri = q * (q + 1) // 2
        flops += Bz * (2 * tri * N * G + H * (2 * tri * P + 4 * q * N * P))
    nbytes = (2 * Bz * S * H * P * itemsize + Bz * S * H * 4
              + 2 * Bz * S * G * N * itemsize + 2 * H * 4 + Bz * H * P * N * 4)
    return nbytes, flops


def phase_timing(errs: dict, launches: dict) -> list:
    gen = torch.Generator(device="cuda").manual_seed(1)
    B = 2 * LANES * mirage_agent.N_EXPERTS
    H, D = TRUNK.n_heads, TRUNK.hd
    q, k, v = flash_inputs(gen, B, HISTORY, HISTORY, H, H, D, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms, variant = timed_variant(flash_attention,
                                lambda: flash_attention(q, k, v, causal=False))
    t = {"ms": ms,
         "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v, causal=False),
                             reps=5),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=False))}
    t["simt_ms"] = time_ms(lambda: flash_launch(
        q, k, v, "simt", causal=False, window=0, softcap=0.0, scale=D ** -0.5),
        reps=5)
    extra = {"ms_l2_warm": time_ms(lambda: flash_attention(q, k, v, causal=False),
                                   flush=False),
             "ms_no_lead": time_ms(lambda: flash_attention(q, k, v, causal=False),
                                   lead=False),
             "host_us": host_us(lambda: flash_attention(q, k, v, causal=False))}
    nbytes = 4 * q.numel() * q.element_size()          # q, k, v read; o written
    flops = 4 * B * H * HISTORY * HISTORY * D          # q.k^T and p.v
    bms, by = bound_ms(nbytes, flops)
    flash_rec = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:33",
        launches=launches["flash_attention"],
        max_abs_err=errs["flash_attention"], bound_ms=bms, bound_by=by,
        variant=variant,
        shape="q,k,v (640,144,8,32) bf16, non-causal: one trunk layer", **t)
    line("time", **flash_rec, **extra)
    del q, k, v, qt, kt, vt

    # flash's streaming form (double-buffered K/V tiles), which sequences
    # too long for the short form take: on no serving path here, so timed
    # at a long causal LM shape beside the CUDA-core variant and SDPA
    Bl, Sl, Hl, Dl = 4, 1024, 8, 128
    q, k, v = flash_inputs(gen, Bl, Sl, Sl, Hl, Hl, Dl, torch.bfloat16)
    qt, kt, vt = (t_.transpose(1, 2).contiguous() for t_ in (q, k, v))
    ms, form_variant = timed_variant(flash_attention,
                                     lambda: flash_attention(q, k, v))
    pairs = Bl * Hl * Sl * (Sl + 1) // 2               # causal triangle
    line("time", name="flash_attention streaming form",
         shape=f"q,k,v ({Bl},{Sl},{Hl},{Dl}) bf16, causal", variant=form_variant,
         ms=ms, simt_ms=time_ms(lambda: flash_launch(
             q, k, v, "simt", causal=True, window=0, softcap=0.0,
             scale=Dl ** -0.5), reps=5),
         library_ms=time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=True)),
         bound_ms=bound_ms(4 * q.numel() * q.element_size(),
                           4 * pairs * Dl)[0])
    del q, k, v, qt, kt, vt

    # one trunk layer's six projections at E=10, C = 2 actions x 32 lanes x 144
    C, d, f = 2 * LANES * HISTORY, TRUNK.d_model, TRUNK.d_ff
    per_layer = [(d, d)] * 4 + [(d, f), (f, d)]
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "simt_ms": 0.0}
    extra = {"ms_l2_warm": 0.0, "ms_no_lead": 0.0, "host_us": 0.0}
    nbytes = flops = 0
    variants = set()
    for din, dout in per_layer:
        x, w = gemm_inputs(gen, mirage_agent.N_EXPERTS, C, din, dout,
                           torch.bfloat16)
        ms, variant = timed_variant(grouped_gemm, lambda: grouped_gemm(x, w))
        one = {"ms": ms,
               "plain_ms": time_ms(lambda: grouped_gemm_ref(x, w), reps=5),
               "library_ms": time_ms(lambda: torch.bmm(x, w)),
               "simt_ms": time_ms(lambda: gemm_launch(x, w, "simt"), reps=3)}
        extra["ms_l2_warm"] += time_ms(lambda: grouped_gemm(x, w), flush=False)
        extra["ms_no_lead"] += time_ms(lambda: grouped_gemm(x, w), lead=False)
        extra["host_us"] += host_us(lambda: grouped_gemm(x, w))
        b = (x.numel() + w.numel() + x.shape[0] * C * dout) * x.element_size()
        fl = 2 * x.shape[0] * C * din * dout
        line("time", name="grouped_gemm", shape=f"({x.shape[0]},{C},{din})x"
             f"({x.shape[0]},{din},{dout}) bf16", variant=variant,
             bound_ms=bound_ms(b, fl)[0], **one)
        variants.add(variant)
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
        variant=variants.pop() if len(variants) == 1 else "mixed",
        shape="the 6 projections of one trunk layer, E=10, C=9216, bf16", **tot)
    line("time", **gemm_rec, **extra)

    # the two norms of one Mamba2 layer at prefill: the block's pre-norm
    # over d_model and out_norm over d_inner, 4 x 2048 rows, bf16, w fp32;
    # then the same two at a decode step's 4 rows, where the launch is the
    # cost
    for rows, what in ((LM_BATCH * LM_PROMPT, "prefill"), (LM_BATCH, "decode")):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "simt_ms": 0.0}
        extra = {"ms_no_lead": 0.0, "host_us": 0.0}
        nbytes = flops = 0
        variants = set()
        for dim in (LM.d_model, LM.d_inner):
            x = _randn(gen, (rows, dim), torch.bfloat16, 3.0)
            w = _randn(gen, (dim,), torch.float32)
            w16 = w.to(torch.bfloat16)

            def norm():
                return rmsnorm(x, w, eps=LM.norm_eps)
            ms, variant = timed_variant(rmsnorm, norm)
            one = {"ms": ms,
                   "plain_ms": time_ms(lambda: rmsnorm_ref(x, w, eps=LM.norm_eps),
                                       reps=5),
                   # the library's fused path wants w in x's dtype
                   "library_ms": time_ms(lambda: F.rms_norm(x, (dim,), w16,
                                                            LM.norm_eps)),
                   "simt_ms": time_ms(lambda: norm_launch(
                       x, w, "simt", eps=LM.norm_eps, gemma=False))}
            extra["ms_no_lead"] += time_ms(norm, lead=False)
            extra["host_us"] += host_us(norm)
            b = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
            fl = 4 * x.numel()            # square-add, scale, weight: fp32
            line("time", name=f"rmsnorm {what}",
                 shape=f"({rows},{dim}) bf16, w fp32", variant=variant,
                 bound_ms=bound_ms(b, fl, FP32_FLOP_PER_S)[0], **one)
            variants.add(variant)
            for key in tot:
                tot[key] += one[key]
            nbytes, flops = nbytes + b, flops + fl
            del x, w, w16
        bms, by = bound_ms(nbytes, flops, FP32_FLOP_PER_S)
        rec = dict(
            name="rmsnorm", route="cuda",
            source="src/repro_torch/csrc/rmsnorm.cu",
            replaces="src/repro/kernels/rmsnorm/kernel.py:17",
            launches=launches["rmsnorm"], max_abs_err=errs["rmsnorm"],
            bound_ms=bms, bound_by=by,
            variant=variants.pop() if len(variants) == 1 else "mixed",
            shape=f"one Mamba2 layer's two {what} norms, ({rows},2048) and "
                  f"({rows},4096) bf16, w fp32", **tot)
        if what == "prefill":
            norm_rec = rec
            line("time", **rec, **extra)
        else:
            line("time", **dict(rec, name="rmsnorm decode step"), **extra)

    # the scan of one Mamba2 layer at prefill
    shape = (LM_BATCH, LM_PROMPT, LM.ssm_nheads, LM.ssm_headdim, LM.ssm_state,
             LM.ssm_ngroups)
    args = ssd_inputs(gen, *shape, torch.bfloat16, False)[:6]

    def scan():
        return ssd(*args, LM.ssm_chunk)
    ms, variant = timed_variant(ssd, scan)
    t = {"ms": ms,
         "plain_ms": time_ms(lambda: ssd_ref(*args, LM.ssm_chunk), reps=5),
         "library_ms": None,                 # no one PyTorch call scans
         "simt_ms": time_ms(lambda: ssd_launch(*args, LM.ssm_chunk, None,
                                               "simt"), reps=5)}
    extra = {"ms_no_lead": time_ms(scan, lead=False), "host_us": host_us(scan)}
    bms, by = bound_ms(*ssd_work(*shape, LM.ssm_chunk, 2))
    ssd_rec = dict(
        name="ssd", route="cuda", source="src/repro_torch/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:31",
        launches=launches["ssd"], max_abs_err=errs["ssd"], bound_ms=bms,
        bound_by=by, variant=variant,
        shape="x (4,2048,64,64) bf16, B/C (4,2048,1,128) bf16, "
        "chunk 256: one Mamba2 layer's prefill scan", **t)
    line("time", **ssd_rec, **extra)
    return [flash_rec, gemm_rec, norm_rec, ssd_rec] + time_backward(
        gen, errs, launches) + time_lm_backward(gen, errs, launches)


class _Identity(torch.autograd.Function):
    """A Function whose backward launches nothing: ``torch.autograd.grad``
    through it times the engine's own cost of one call."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g


def gemm_bwd_host(x, w, dy, out) -> dict:
    """Host microseconds of one projection's backward and of its parts,
    each timed alone with ``host_us`` (the card asleep): through autograd
    and called directly, on the fused route and on the two-launch one (the
    engine's hand-off is the difference), the variant choice, the three
    ``torch.empty`` (dX, dW, the split-K workspace), a ``torch.cuda.device``
    switch (the fused route skips it on the current device), the Wᵀ copy
    of the two-launch route, and the C entry point: called with nothing to
    do (ctypes alone), with dX only (3 tensor maps) and with both (6); the
    difference of the last two is three ``cuTensorMapEncodeTiled``. The
    engine's floor is ``torch.autograd.grad`` through a Function whose
    backward launches nothing."""
    xd, wd = x.detach(), w.detach()
    E, C, d = xd.shape
    f = wd.shape[2]
    dev = xd.device
    tiles = E * -(-d // gemm_ops.BLOCK_M) * -(-f // gemm_ops.BLOCK_N)
    sms, counters = gemm_ops._device_state(dev, tiles)
    splits = gemm_ops.split_count(E, d, f, C, sms)
    dx, dw = torch.empty_like(xd), torch.empty_like(wd)
    part = torch.empty(tiles * splits * gemm_ops.BLOCK_M * gemm_ops.BLOCK_N,
                       device=dev)
    fn = _build.load("moe_gemm", "grouped_gemm_bwd")

    def call(dx_ptr, dw_ptr):
        return lambda: fn(xd.data_ptr(), wd.data_ptr(), dy.data_ptr(), dx_ptr,
                          dw_ptr, part.data_ptr() if splits > 1 else None,
                          counters.data_ptr(), E, C, d, f, splits,
                          *gemm_ops._strides(xd, wd),
                          *gemm_ops._lead_strides(dy),
                          torch.cuda.current_stream().cuda_stream)

    def switch():
        with torch.cuda.device(dev):
            pass

    def grad():
        return torch.autograd.grad(out, (x, w), dy, retain_graph=True)
    us = {"autograd_us": host_us(grad),
          "backward_us": host_us(lambda: gemm_ops._backward(
              xd, wd, dy, True, True)),
          "variant_us": host_us(lambda: gemm_ops._bwd_variant(xd, wd, dy)),
          "empty_us": host_us(lambda: (
              torch.empty_like(xd), torch.empty_like(wd),
              torch.empty(part.numel(), device=dev))),
          "device_switch_us": host_us(switch),
          "ctypes_us": host_us(call(None, None)),
          "c_dx_us": host_us(call(dx.data_ptr(), None)),
          "c_both_us": host_us(call(dx.data_ptr(), dw.data_ptr())),
          "old_backward_us": host_us(lambda: gemm_ops._backward_two_launches(
              xd, wd, dy, True, True)),
          "wt_copy_us": host_us(lambda: wd.transpose(1, 2).contiguous())}
    fused_variant = gemm_ops._bwd_variant
    gemm_ops._bwd_variant = lambda *args: "simt"    # the two-launch route
    try:
        us["old_autograd_us"] = host_us(grad)
    finally:
        gemm_ops._bwd_variant = fused_variant
    leaf = torch.zeros(8, device=dev, requires_grad=True)
    ident, ones = _Identity.apply(leaf), torch.ones(8, device=dev)
    us["engine_floor_us"] = host_us(lambda: torch.autograd.grad(
        ident, leaf, ones, retain_graph=True))
    us["engine_us"] = us["autograd_us"] - us["backward_us"]
    us["encode3_us"] = us["c_both_us"] - us["c_dx_us"]
    us["launch_us"] = us["c_both_us"] - us["ctypes_us"] - 2 * us["encode3_us"]
    return us


def time_backward(gen, errs: dict, launches: dict) -> list:
    """The backward kernels at the trunk's training shapes: flash's at one
    layer, (640,144,8,32) bf16, from the forward's out and lse; the GEMM's
    at one layer, dX and dW of its 6 projections through autograd as
    training runs them (one launch of the fused kernel a projection),
    beside the two-launch route of the same products (``old_ms``: dX on a
    copy of Wᵀ, dW through the forward kernel's transposed-x mode) and each
    product alone from the fused kernel (``dx_only_ms``, ``dw_only_ms``), with
    the host time split as ``gemm_bwd_host`` gives it. Beside each: the
    plain version, the library's backward (SDPA's through
    ``torch.autograd.grad``; two ``torch.bmm`` a projection on transposed
    views) and the bound."""
    B = 2 * LANES * mirage_agent.N_EXPERTS
    H, D = TRUNK.n_heads, TRUNK.hd
    q, k, v = flash_inputs(gen, B, HISTORY, HISTORY, H, H, D, torch.bfloat16)
    do = _randn(gen, q.shape, torch.bfloat16)
    o, lse = flash_launch(q, k, v, "tc", causal=False, window=0, softcap=0.0,
                          scale=D ** -0.5, lse=True)

    def bwd():
        return flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    ms, variant = timed_variant(flash_attention_bwd, bwd)
    t = {"ms": ms,
         "plain_ms": time_ms(lambda: flash_attention_bwd_ref(
             q, k, v, o, lse, do, causal=False), reps=5),
         "simt_ms": time_ms(lambda: flash_launch_bwd(
             q, k, v, o, lse, do, "simt", causal=False, softcap=0.0,
             scale=D ** -0.5), reps=5)}
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=False)
    dot = do.transpose(1, 2).contiguous()
    t["library_ms"] = time_ms(lambda: torch.autograd.grad(
        sdpa, (qt, kt, vt), dot, retain_graph=True))
    extra = {"ms_no_lead": time_ms(bwd, lead=False), "host_us": host_us(bwd)}
    nbytes = 8 * q.numel() * q.element_size()   # q k v o dO read; dq dk dv
    flops = 5 * 2 * B * H * HISTORY * HISTORY * D   # q.k^T again, 4 products
    bms, by = bound_ms(nbytes, flops)
    flash_rec = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/attention.py:168",
        launches=launches["flash_attention_bwd"],
        max_abs_err=errs["flash_attention_bwd"], bound_ms=bms, bound_by=by,
        variant=variant,
        shape="q,k,v,o,dO (640,144,8,32) bf16, non-causal: one trunk "
              "layer's backward", **t)
    line("time", **flash_rec, **extra)
    del q, k, v, o, lse, do, qt, kt, vt, sdpa, dot

    C, d, f = 2 * LANES * HISTORY, TRUNK.d_model, TRUNK.d_ff
    E = mirage_agent.N_EXPERTS
    tot = {"ms": 0.0, "old_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    extra = defaultdict(float)
    nbytes = flops = 0
    variants = set()
    for din, dout in [(d, d)] * 4 + [(d, f), (f, d)]:
        x, w = (t_.requires_grad_(True) for t_ in gemm_inputs(
            gen, E, C, din, dout, torch.bfloat16))
        dy = _randn(gen, (E, C, dout), torch.bfloat16)
        out = grouped_gemm(x, w)

        def bwd():
            return torch.autograd.grad(out, (x, w), dy, retain_graph=True)
        n, n_tc = grouped_gemm.bwd_launches, grouped_gemm.bwd_tc_launches
        calls = grouped_gemm.bwd_fused_calls
        ms = time_ms(bwd)
        n, n_tc, calls = (grouped_gemm.bwd_launches - n,
                          grouped_gemm.bwd_tc_launches - n_tc,
                          grouped_gemm.bwd_fused_calls - calls)
        variant = ("tc" if n_tc == n == 2 * calls else
                   "simt" if not n_tc else "mixed")
        xd, wd = x.detach(), w.detach()
        one = {"ms": ms,
               "old_ms": time_ms(lambda: gemm_ops._backward_two_launches(
                   xd, wd, dy, True, True)),
               "plain_ms": time_ms(lambda: grouped_gemm_bwd_ref(xd, wd, dy),
                                   reps=5),
               "library_ms": time_ms(lambda: (
                   torch.bmm(dy, wd.transpose(1, 2)),
                   torch.bmm(xd.transpose(1, 2), dy)))}
        # each product alone from the same kernel: what one grid for both
        # saves over two launches of it
        for key, need in (("dx_only_ms", (True, False)),
                          ("dw_only_ms", (False, True))):
            extra[key] += time_ms(lambda: gemm_ops._launch_bwd(
                xd, wd, dy, *need))
        extra["ms_no_lead"] += time_ms(bwd, lead=False)
        host = gemm_bwd_host(x, w, dy, out)
        extra["host_us"] += host["autograd_us"]
        extra["old_host_us"] += host["old_autograd_us"]
        b = 2 * (2 * x.numel() + 2 * w.numel() + dy.numel())  # x w dy; dx dw
        fl = 2 * 2 * E * C * din * dout
        line("time", name="grouped_gemm_bwd",
             shape=f"dX, dW of ({E},{C},{din})x({E},{din},{dout}) bf16",
             variant=variant, splits=gemm_ops.split_count(
                 E, din, dout, C,
                 torch.cuda.get_device_properties(0).multi_processor_count),
             bound_ms=bound_ms(b, fl)[0], **one, host=host)
        variants.add(variant)
        for key in tot:
            tot[key] += one[key]
        nbytes, flops = nbytes + b, flops + fl
        del x, w, dy, out, xd, wd
    bms, by = bound_ms(nbytes, flops)
    gemm_rec = dict(
        name="grouped_gemm_bwd", route="cuda",
        source="src/repro_torch/csrc/moe_gemm.cu",
        replaces="src/repro/kernels/moe_gemm/kernel.py:23",
        launches=launches["grouped_gemm_bwd"],
        products=launches["grouped_gemm_bwd_products"],
        max_abs_err=errs["grouped_gemm_bwd"], bound_ms=bms, bound_by=by,
        variant=variants.pop() if len(variants) == 1 else "mixed",
        shape="dX and dW of one trunk layer's 6 projections, E=10, C=9216, "
              "bf16, one fused launch a projection", **tot)
    line("time", **gemm_rec, **extra)
    return [flash_rec, gemm_rec]


def ssd_bwd_work(Bz, S, H, P, N, G, chunk, itemsize):
    """Bytes and products the scan's backward needs: x, dy, dt, B, C read
    and dx, ddt, dB, dC written once (A, D, dA, dD negligible); per chunk of
    q rows, C.B^T once per group over the causal triangle, and per head
    dy.x^T, the scores' products with dy and x (dx) and dCB's with C and B
    (dB, dC) over the triangle, and five (q x P x N) products for the state
    terms (the chunk state and its dy twin, dS.B, dS^T.x, S_in^T.dy; seg's
    state share is C_t . (S_in^T dy_t), from the last, so S_in.C is not
    needed)."""
    Q = min(chunk, S)
    flops = 0
    for s0 in range(0, S, Q):
        q = min(Q, S - s0)
        tri = q * (q + 1) // 2
        flops += Bz * (2 * tri * N * G
                       + H * (4 * tri * P + 4 * tri * N + 10 * q * P * N))
    nbytes = (3 * Bz * S * H * P * itemsize + 2 * Bz * S * H * 4
              + 4 * Bz * S * G * N * itemsize)
    return nbytes, flops


def ssd_bwd_host(args, dy, Q, rounds=5) -> dict:
    """Host microseconds of one SSD backward call and of its parts, each
    timed alone with ``host_us`` (the card asleep), the median of
    ``rounds`` rounds that take every part in turn: the wrapper
    ``ssd_bwd``, the variant choice, ``_launch_bwd`` with either variant on
    the same inputs, its thirteen ``torch.empty``, and the C entry point
    alone with either variant on buffers made once (ctypes, the launches'
    set-up and their five kernel launches). ``rest_tc_us`` and
    ``rest_simt_us`` are what ``_launch_bwd`` spends beside the last two,
    ``rest_wrapper_us`` what the wrapper spends beside the variant choice
    and ``_launch_bwd``: its Python."""
    x, dt, A, B, C, D = args
    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = -(-S // Q)

    def empties():
        def empty(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device=x.device)
        return [empty(Bz, S, H, P, dtype=x.dtype), empty(Bz, S, H), empty(H),
                empty(Bz, S, G, N, dtype=B.dtype),
                empty(Bz, S, G, N, dtype=B.dtype), empty(H),
                empty(Bz, nc, H, P, N), empty(Bz, nc, H, P, N),
                *(empty(Bz, nc, H) for _ in range(3)),
                empty(Bz, S, H, N), empty(Bz, S, H, N)]
    dx, ddt, dA, dB, dC, dD, states, ubuf, totals, dAp, dDp, dBh, dCh = (
        empties())
    fn = _build.load("ssd_bwd")
    ptrs = [None if t is None else t.data_ptr() for t in (
        x, dt, A, B, C, D, None, dy, None, dx, ddt, dA, dB, dC, dD, None,
        states, ubuf, totals, dBh, dCh, dAp, dDp)]

    def c_call(variant):
        def call():
            err = fn(*ptrs, _build.DTYPE_CODES[x.dtype],
                     _build.VARIANT_CODES[variant], Bz, S, H, G, P, N, Q,
                     *x.stride()[:3], *dt.stride(), *B.stride()[:3],
                     *C.stride()[:3], torch.cuda.current_stream().cuda_stream)
            _build.check_launch("ssd_bwd", err)
        return call

    def launch(variant):
        return lambda: ssd_launch_bwd(*args, Q, dy, None, None, variant)
    parts = {"wrapper_us": lambda: ssd_bwd(*args, Q, dy),
             "variant_us": lambda: ssd_ops._ssd_bwd_variant(x, B, C, dy, Q),
             "launch_tc_us": launch("tc"), "launch_simt_us": launch("simt"),
             "empty_us": empties, "c_tc_us": c_call("tc"),
             "c_simt_us": c_call("simt")}
    got = defaultdict(list)
    for _ in range(rounds):
        for name, part in parts.items():
            got[name].append(host_us(part, reps=10))
    us = {name: float(np.median(v)) for name, v in got.items()}
    for v in ("tc", "simt"):
        us[f"rest_{v}_us"] = (us[f"launch_{v}_us"] - us["empty_us"]
                              - us[f"c_{v}_us"])
    us["rest_wrapper_us"] = (us["wrapper_us"] - us["variant_us"]
                             - us["launch_tc_us"])
    return us


def _bwd_variant(counter, n_fast, n_all, fast: str) -> str:
    """The variant the timed backward calls ran, from the counts of their
    launches (all, and of the fast variant) since ``n_all`` / ``n_fast``."""
    ran, ran_fast = counter()[0] - n_all, counter()[1] - n_fast
    if not ran:
        raise RuntimeError("the timed backward launched nothing")
    return fast if ran_fast == ran else "simt" if not ran_fast else "mixed"


def time_lm_backward(gen, errs: dict, launches: dict) -> list:
    """The RMSNorm and SSD backward kernels at phase 8's (b) shapes: one
    Mamba2 layer's two norm backwards, (4096,2048) and (4096,4096) bf16 with
    an fp32 w, and its scan's backward, x (2,2048,64,64) bf16, N=128,
    chunk 256; the variant the wrapper picks (``ms``) beside the other one
    at the same shapes (``simt_ms``: the strided-column norm backward, the
    CUDA-core scan backward), their plain versions, the library's
    (autograd through ``F.rms_norm``; none for the scan) and the bound."""
    rows = LM_TRAIN_RUNS[1][1] * LM_TRAIN_RUNS[1][2]
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    extra = {"simt_ms": 0.0, "ms_no_lead": 0.0, "host_us": 0.0}
    variants = set()
    nbytes = flops = 0

    def norm_counts():
        return rmsnorm.bwd_launches, rmsnorm.bwd_vec_launches
    for dim in (LM.d_model, LM.d_inner):
        x = _randn(gen, (rows, dim), torch.bfloat16, 3.0)
        w = 1.0 + 0.1 * _randn(gen, (dim,), torch.float32)
        dy = _randn(gen, (rows, dim), torch.bfloat16)

        def bwd():
            return rmsnorm_bwd(x, w, dy, eps=LM.norm_eps)
        n_all, n_fast = norm_counts()
        ms = time_ms(bwd)
        variants.add(_bwd_variant(norm_counts, n_fast, n_all, "vec"))
        xl = x.clone().requires_grad_(True)
        wl = w.to(torch.bfloat16).requires_grad_(True)
        lib = F.rms_norm(xl, (dim,), wl, LM.norm_eps)
        one = {"ms": ms,
               "plain_ms": time_ms(lambda: rmsnorm_bwd_ref(
                   x, w, dy, eps=LM.norm_eps), reps=5),
               "library_ms": time_ms(lambda: torch.autograd.grad(
                   lib, (xl, wl), dy, retain_graph=True))}
        simt = time_ms(lambda: norm_launch_bwd(x, w, dy, "simt",
                                               eps=LM.norm_eps, gemma=False))
        extra["simt_ms"] += simt
        extra["ms_no_lead"] += time_ms(bwd, lead=False)
        extra["host_us"] += host_us(bwd)
        b = 3 * x.numel() * x.element_size() + 2 * w.numel() * 4
        fl = 10 * x.numel()         # the two row sums, dx, dy.x.r: fp32
        line("time", name="rmsnorm_bwd", shape=f"({rows},{dim}) bf16, w fp32",
             bound_ms=bound_ms(b, fl, FP32_FLOP_PER_S)[0], simt_ms=simt,
             **one)
        for key in tot:
            tot[key] += one[key]
        nbytes, flops = nbytes + b, flops + fl
        del x, w, dy, xl, wl, lib
    bms, by = bound_ms(nbytes, flops, FP32_FLOP_PER_S)
    norm_rec = dict(
        name="rmsnorm_bwd", route="cuda",
        source="src/repro_torch/csrc/rmsnorm_bwd.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:17",
        launches=launches["rmsnorm_bwd"], max_abs_err=errs["rmsnorm_bwd"],
        bound_ms=bms, bound_by=by,
        variant=variants.pop() if len(variants) == 1 else "mixed",
        shape=f"one Mamba2 layer's two norm backwards, ({rows},2048) and "
              f"({rows},4096) bf16, w fp32", **tot)
    line("time", **norm_rec, **extra)

    Bz, S = LM_TRAIN_RUNS[1][1:3]
    shape = (Bz, S, LM.ssm_nheads, LM.ssm_headdim, LM.ssm_state,
             LM.ssm_ngroups)
    args = ssd_inputs(gen, *shape, torch.bfloat16, False)[:6]
    dy = _randn(gen, args[0].shape, torch.bfloat16)

    def bwd():
        return ssd_bwd(*args, LM.ssm_chunk, dy)

    def ssd_counts():
        return ssd.bwd_launches, ssd.bwd_tc_launches
    n_all, n_fast = ssd_counts()
    t = {"ms": time_ms(bwd, reps=10)}
    variant = _bwd_variant(ssd_counts, n_fast, n_all, "tc")
    t.update(plain_ms=time_ms(lambda: ssd_bwd_ref(*args, LM.ssm_chunk, dy),
                              reps=3),
             library_ms=None)                 # no one PyTorch call does it
    Q = min(LM.ssm_chunk, S)
    extra = {"simt_ms": time_ms(lambda: ssd_launch_bwd(
                 *args, Q, dy, None, None, "simt"), reps=5),
             "ms_no_lead": time_ms(bwd, reps=10, lead=False),
             "host_us": host_us(bwd, reps=10),
             "host": ssd_bwd_host(args, dy, Q)}
    bms, by = bound_ms(*ssd_bwd_work(*shape, LM.ssm_chunk, 2))
    ssd_rec = dict(
        name="ssd_bwd", route="cuda", source="src/repro_torch/csrc/ssd_bwd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:31",
        launches=launches["ssd_bwd"], max_abs_err=errs["ssd_bwd"],
        bound_ms=bms, bound_by=by, variant=variant,
        shape=f"x, dy ({Bz},{S},64,64) bf16, B/C ({Bz},{S},1,128) bf16, "
              "chunk 256: one Mamba2 layer's scan backward", **t)
    line("time", **ssd_rec, **extra)
    return [norm_rec, ssd_rec]


def phase(name: str, fn, *args):
    """Run one phase and print its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    line("phase", name=name, wall_s=time.perf_counter() - t0)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    phase("1 build", phase_build)
    errs = phase("2 kernels", phase_kernels)
    trace, cfg, venv = agent_env()
    launches = phase("3 agent serving", phase_serve, venv)
    launches.update(phase("4 Mamba2 serving", phase_lm))
    launches.update(phase("4b agent training", phase_train, trace, cfg, venv))
    policies, grid = phase("6 grid", phase_grid)
    service = phase("7 service", phase_service, policies)
    del policies
    torch.cuda.empty_cache()
    lm_train = phase("8 Mamba2 training", phase_lm_train)
    for counts in (grid, service, lm_train):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    records = phase("5 timing", phase_timing, errs, launches)
    print(json.dumps({"kernels": records}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
