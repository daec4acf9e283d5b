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
   flash's (with the forward's row log-sum-exp) and the GEMM's two products;
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
   flash backward and 12 GEMM backward launches a layer), one full-width
   ``train_on``'s gradients at batch 4 held against the CPU plain path, and
   a torch.profiler pass over 3 ``train_on`` steps;
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
   at the trunk's shapes (flash's at one layer, the GEMM's 12 launches of
   one layer) beside SDPA's backward and ``torch.bmm``.

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

from repro_torch.configs import mamba2_1_3b, mirage_agent  # noqa: E402
from repro_torch.convert import tree_map  # noqa: E402
from repro_torch.core import (DQNConfig, DQNLearner,  # noqa: E402
                              FoundationConfig, LearnerPolicy, PGConfig,
                              PGLearner, Policy, ReactivePolicy,
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
from repro_torch.kernels.moe_gemm.ops import (  # noqa: E402
    _launch as gemm_launch)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm.ops import (  # noqa: E402
    _launch as norm_launch)
from repro_torch.kernels.ssd import ssd, ssd_ref  # noqa: E402
from repro_torch.kernels.ssd.ops import _launch as ssd_launch  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.sim import get_scenario, make_env, make_vector_env  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402

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

LM = mamba2_1_3b.CONFIG
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 32
LM_PLAIN_LAYERS, LM_PLAIN_PROMPT = 2, 512   # the kernel-vs-plain model check
NORMS_PER_PASS = 2 * LM.n_layers + 1        # block norms, out_norms, final
LM_REL_TOL = 2e-2       # bf16 model outputs: 2e-2 of the output's largest
                        # magnitude (a few bf16 ulps, as in the CPU tests)


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
    and dW, two launches of the GEMM kernel each named by the variant that
    ran (in bf16 dW reads x in place, transposed by the tensor-core kernel),
    against ``grouped_gemm_bwd_ref``."""
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
              (E, C, a, b, torch.bfloat16), BF16_TOL)
             for a, b in ((d, d), (d, f), (f, d))]
    cases += [("gemm bwd ragged (3,1001,200)x(3,200,136) bf16",
               (3, 1001, 200, 136, torch.bfloat16), BF16_TOL),
              ("gemm bwd ragged (3,1001,200)x(3,200,136) fp32",
               (3, 1001, 200, 136, torch.float32), FP32_GEMM_BWD_TOL)]
    for name, shape, tol in cases:
        x, w = (t.requires_grad_(True) for t in gemm_inputs(gen, *shape))
        dy = _randn(gen, (shape[0], shape[1], shape[3]), shape[4])
        before = _bwd_counts()
        dx, dw = torch.autograd.grad(grouped_gemm(x, w), (x, w), dy)
        torch.cuda.synchronize()
        n, n_tc = (a - b for a, b in zip(_bwd_counts()[1:3], before[1:3]))
        variant = "tc" if n_tc == n else "simt" if not n_tc else "mixed"
        want = "tc" if shape[4] == torch.bfloat16 else "simt"
        if n != 2 or variant != want:
            raise RuntimeError(f"{name}: {n} backward launches ({n_tc} on "
                               f"the tensor cores), expected 2 {want}")
        rdx, rdw = grouped_gemm_bwd_ref(x.detach(), w.detach(), dy)
        err = max(_err(dx, rdx, tol, tol, name + " dX"),
                  _err(dw, rdw, tol, tol, name + " dW"))
        errs["grouped_gemm_bwd"] = max(errs.get("grouped_gemm_bwd", 0.0),
                                       err)
        line("check", case=name, variant=variant, max_abs_err=err, atol=tol,
             rtol=tol)
        del x, w, dy, dx, dw, rdx, rdw


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
    for kern in kernels:
        kern.launches = kern.tc_launches = 0
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
def _set_train_counts() -> None:
    for kern in (flash_attention, grouped_gemm):
        kern.launches = kern.tc_launches = 0
    flash_attention_bwd.launches = flash_attention_bwd.tc_launches = 0
    grouped_gemm.bwd_launches = grouped_gemm.bwd_tc_launches = 0


def _check_backward_counts(what: str, trunk_passes: int) -> dict:
    """The backward launches since the counts were zeroed must be those of
    ``trunk_passes`` differentiated trunk passes: per layer one flash
    backward and GEMM_BWD_PER_LAYER GEMM backward launches."""
    counts = {"flash_bwd_launches": flash_attention_bwd.launches,
              "flash_bwd_tc_launches": flash_attention_bwd.tc_launches,
              "gemm_bwd_launches": grouped_gemm.bwd_launches,
              "gemm_bwd_tc_launches": grouped_gemm.bwd_tc_launches}
    want = (trunk_passes * TRUNK.n_layers * FLASH_PER_LAYER,
            trunk_passes * TRUNK.n_layers * GEMM_BWD_PER_LAYER)
    if not trunk_passes or (counts["flash_bwd_launches"],
                            counts["gemm_bwd_launches"]) != want:
        raise RuntimeError(f"{what}: {counts} for {trunk_passes} trunk "
                           f"passes, expected {want} flash and GEMM backward")
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
            "grouped_gemm_bwd": totals["gemm_bwd_launches"]}


# ----------------------------------------------- 4. Mamba2-1.3B serving
def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _rel_err(out, ref, what) -> float:
    """max|out - ref| within LM_REL_TOL of ref's largest magnitude."""
    out, ref = out.float().cpu(), ref.float().cpu()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise RuntimeError(f"{what}: bad output {out.shape} vs {ref.shape}")
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    if err > LM_REL_TOL * scale:
        raise RuntimeError(f"{what}: kernel path off the plain path by {err}"
                           f" (scale {scale}, tolerance {LM_REL_TOL} of it)")
    return err


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
        gen, errs, launches)


def time_backward(gen, errs: dict, launches: dict) -> list:
    """The backward kernels at the trunk's training shapes: flash's at one
    layer, (640,144,8,32) bf16, from the forward's out and lse; the GEMM's
    at one layer, dX and dW of its 6 projections (12 launches, with the
    copies of Wᵀ that dX reads), through autograd as training runs them. Beside each: the plain version, the library's backward
    (SDPA's through ``torch.autograd.grad``; two ``torch.bmm`` a
    projection on transposed views) and the bound."""
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
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0}
    extra = {"ms_no_lead": 0.0, "host_us": 0.0}
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
        ms = time_ms(bwd)
        n, n_tc = (grouped_gemm.bwd_launches - n,
                   grouped_gemm.bwd_tc_launches - n_tc)
        variant = "tc" if n_tc == n else "simt" if not n_tc else "mixed"
        xd, wd = x.detach(), w.detach()
        one = {"ms": ms,
               "plain_ms": time_ms(lambda: grouped_gemm_bwd_ref(xd, wd, dy),
                                   reps=5),
               "library_ms": time_ms(lambda: (
                   torch.bmm(dy, wd.transpose(1, 2)),
                   torch.bmm(xd.transpose(1, 2), dy)))}
        extra["ms_no_lead"] += time_ms(bwd, lead=False)
        extra["host_us"] += host_us(bwd)
        b = 2 * (2 * x.numel() + 2 * w.numel() + dy.numel())  # x w dy; dx dw
        fl = 2 * 2 * E * C * din * dout
        line("time", name="grouped_gemm_bwd",
             shape=f"dX, dW of ({E},{C},{din})x({E},{din},{dout}) bf16",
             variant=variant, bound_ms=bound_ms(b, fl)[0], **one)
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
        max_abs_err=errs["grouped_gemm_bwd"], bound_ms=bms, bound_by=by,
        variant=variants.pop() if len(variants) == 1 else "mixed",
        shape="dX and dW of one trunk layer's 6 projections, E=10, C=9216, "
              "bf16, with the copies of W^T", **tot)
    line("time", **gemm_rec, **extra)
    return [flash_rec, gemm_rec]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    phase_build()
    errs = phase_kernels()
    trace, cfg, venv = agent_env()
    launches = phase_serve(venv)
    launches.update(phase_lm())
    launches.update(phase_train(trace, cfg, venv))
    records = phase_timing(errs, launches)
    print(json.dumps({"kernels": records}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
