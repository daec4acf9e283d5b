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
   case checks through the launch counters which variant ran (flash, at
   TinyLlama's causal GQA prefill shape (4,2048,32/4,64), Qwen2-MoE's
   (4,2048,16/16,128), Qwen1.5-4B's (4,2048,20/20,128), Command-R's
   (4,2048,64/8,128), Qwen2-VL's (4,2048,28/4,128), a group of 7, and
   Gemma-3's (4,2048,32/16,128), with its local
   layers' window of 1024 and without (its global layers), and ragged at
   (2,1100,32/16,128) with the window, among others, the GEMM (at the
   Qwen2-MoE experts' prefill and decode shapes too) and the SSD scan:
   bf16 on the tensor cores, fp32 and unaligned inputs on the CUDA cores;
   the GEMM also at DeepSeek-V2's 160 experts, a prefill's 384 rows an
   expert and a decode step's 4, through wi and wo; RMSNorm: 16-byte
   vectors, Gemma-3's (1 + w) at its QK-norm's (262144, 128) and its
   d_model's (8192, 5376) and DeepSeek-V2's q and kv ranks, (8192, 1536)
   and (8192, 512), and Zamba2-7B's d_model and d_inner, (8192, 3584) and
   (8192, 7168), the vec form's limit of 896 vectors, among them, and one
   element per lane for rows off 16 bytes and for 897 vectors; the scan
   also at Zamba2-7B's 112 heads of 64 with N = 64, at its prefill and
   ragged with an initial state); the backward kernels through autograd:
   flash's (with the forward's row log-sum-exp; bf16 on the tensor cores in
   the short form at the trunk's MHA heads and in the streaming form for
   GQA, D = 128, long and ragged sequences, TinyLlama's training layer
   (2,2048,32/4,64), Qwen2-MoE's heads at (2,1024,16/16,128), Qwen1.5-4B's
   training layer (2,2048,20/20,128), Qwen2-VL's (2,2048,28/4,128), one
   share of its group of 7, Command-R's (2,2048,64/8,128), one share of
   its group of 8, and at a batch of 1, two shares, and Gemma-3's
   local and global training layers at (2,2048,32/16,128); with the
   window mask in every form: 1024 at S 2048, 1000 at a ragged S of 2050,
   48 (under one tile), the short form at S 144; each "tc" case also
   through the "simt" kernels on the same inputs and held to the same
   bound, and every case the same bit for bit over repeated calls; fp32 on
   the CUDA cores) and the GEMM's (in bf16 both
   products from one launch of the fused kernel, dW split along C and the
   same bit for bit over repeated calls, at Qwen2-MoE's training shapes
   and DeepSeek-V2's, 160 experts of 96 rows, too), and RMSNorm's
   (Gemma-3's block norms at (4096,5376) with gemma, DeepSeek-V2's q
   and kv norms at (2048,1536) and (2048,512), Qwen2-VL's block norms at
   (4096,3584) and Zamba2-7B's out_norm at (4096,7168), 896 vectors a row
   on two warps, plain and gemma, and 897 vectors on "simt", among them)
   and the SSD scan's (Zamba2-7B's training layer, x (2,2048,112,64) with
   N = 64, and ragged at its 112 heads among them)
   at phase 8's shapes, ragged rows and chunks, chunks whose length is not
   a multiple of the scan backward's tiles (100, and the smoke config's
   16), d off 8, gemma, G = 2, P = 128, an initial state and the final
   state's gradient, fp32 and bf16, each case's variant checked through
   the counters (RMSNorm's "vec" and the scan's "tc" for bf16 they can
   address, "simt" otherwise) and, where that is the fast one, the "simt"
   variant held to the same bound on the same inputs; their reductions
   (dw; dA, dB, dC, dD) the same bit for bit over repeated calls; flash
   at the head dims 48, 80, 96 and 112 (HuBERT X-Large's 80, Zamba2-7B's
   112: the Hopper form on its D = 64 or 128 kernels, the columns past D
   read as zeros) and 72 (the CUDA cores only), causal GQA with a window
   and softcap at ragged 97|131, causal GQA at a ragged 333 and MHA at 64,
   bf16 and fp32, through autograd with each launch's variant and form
   counted both ways, then every other tensor-core form its shapes take,
   named, both ways, all against the plain versions;
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
4c. TinyLlama-1.1B serving at its full published width and depth, seeded
   random weights drawn on the card (fp32, ~1.1 B parameters, bf16
   compute): after a warm-up, ``make_prefill_step`` on 4 prompts of 2048
   tokens into a cache of 2048 + 32 positions and 32 greedy
   ``make_serve_step`` decode steps, raising unless each prefill launched
   exactly 22 flash kernels, all on the tensor cores (the streaming form,
   causal, 32 q heads over 4 kv heads of 64), and 45 RMSNorm kernels, all
   vectorised, and each decode step no flash and 45 RMSNorm; finite
   logits; the first 2 layers' last-token logits and KV cache held against
   the plain path on the CPU at 1 x 512; a prefill and 5 decode steps under
   torch.profiler; ``repro_torch.launch.serve --arch tinyllama-1.1b`` at
   its defaults (every request done, no flash launch, RMSNorm a multiple
   of 45);
4d. Qwen1.5-MoE-A2.7B serving at its full published width and depth
   (24 layers, d 2048, 16 heads of 128, 60 routed experts top-4 + 4 shared
   of d_ff 1408, vocab 151,936), seeded random weights drawn on the card
   (fp32, ~14.3 B parameters, bf16 compute) with the QKV biases drawn
   nonzero: as 4c, a 4 x 2048 prefill into a cache of 2,080 and 32 decode
   steps, raising unless each prefill launched exactly 48 grouped GEMMs
   (the routed experts' wi and wo a layer), 24 flash and 49 RMSNorm, every
   GEMM and flash on the tensor cores and every norm vectorised, and each
   step 48, 0 and 49; the peak memory; the (token, k) pairs a prefill
   drops at capacity; the first 2 layers' last-token logits and KV cache
   against the plain path on the CPU at 1 x 512 (the CPU run takes the card
   run's experts; every token the CPU's own router would send elsewhere is
   counted and must be a near-tie); a prefill and a decode step under
   torch.profiler, by kernel group; the drops again with the QKV biases
   at the init's zeros; ``repro_torch.launch.serve --arch
   qwen2-moe-a2.7b`` at its defaults;
4e. Gemma-3-27B serving at its full published width (d 5376, 32 q heads
   over 16 kv heads of 128, d_ff 21504, vocab 262,144, QK-norm, sandwich
   norms, (1 + w) norm scales, a tied table) and 26 of its 62 layers,
   4 x (5 local + 1 global) + 2 local (fp32 weights of all 62 exceed the
   card), seeded fp32 weights drawn on the card (~12.1 B parameters, bf16
   compute) with every norm scale drawn N(0, 0.1) in place of the init's
   zeros: as 4c, a 4 x 2048 prefill into a cache of 2,080 (1,024-slot
   rings on the local layers) and 32 decode steps, which wrap every ring,
   raising unless each prefill launched exactly 26 flash kernels, all on
   the tensor cores, 22 with the window of 1024 and 4 without, and 157
   RMSNorm, all vectorised, and each step no flash and 157 RMSNorm; the
   peak memory; the first local and the first global layer as a 2-layer
   model, a 1,088-token prefill (past the window) and 4 decode steps,
   every call's logits and both K/V caches against the plain path on the
   CPU; a prefill and 5 decode steps under torch.profiler, by kernel
   group; ``ServeEngine`` at the serve launcher's defaults on the same
   weights (every request done, no flash launch, RMSNorm a multiple of
   157);
4f. DeepSeek-V2-236B serving at its full published width (d 5120, 128
   heads with MLA: q rank 1,536, kv rank 512, nope 128 + rope 64, v 128;
   160 routed experts top-6 + 2 shared of d_ff 1,536; vocab 102,400) and 4
   of its 60 layers, the dense first layer and 3 MoE layers (fp32 weights
   of all 60 are ~940 GB by their shapes), seeded fp32 weights drawn on the card (~13.1 B
   parameters, bf16 compute) with every norm scale drawn N(1, 0.3): as 4c,
   a 4 x 2048 prefill (MLA's latent-chunked attention) into a latent cache
   of 2,080 and 32 decode steps (the absorbed decode), raising unless each
   prefill and each step launched exactly 6 grouped GEMMs, all on the
   tensor cores, 17 RMSNorm, all vectorised, and no flash kernel; the
   peak memory; the (token, k) pairs dropped at the prefill and at the
   decode steps, and the tokens whose router is within a near-tie; the
   dense first layer and the first MoE layer as a 2-layer model, a 1 x 256
   prefill and a decode step, every call's logits and both latent caches
   against the plain path on the CPU (the CPU run takes the card run's
   experts; every token the CPU's own router would send elsewhere is
   counted and must be a near-tie); the absorbed decode of a 256-token
   prompt's last position against ``mla_forward``'s expanded output for
   it, at 128 heads and kv rank 512; a prefill and 5 decode steps under
   torch.profiler, by kernel group; ``ServeEngine`` at the serve
   launcher's defaults on the same weights;
4g. Qwen1.5-4B serving at its full published width and depth (40 layers,
   d 2560, 20 heads of 128 over as many kv heads, d_ff 6912, vocab
   151,936, QKV bias, RoPE theta 5e6), seeded fp32 weights drawn on the
   card (3.95 B parameters) with the QKV biases drawn nonzero: as 4c, a 4
   x 2048 prefill into a cache of 2,080 and 32 decode steps, raising
   unless each prefill launched exactly 40 flash kernels (tc) and 81
   RMSNorm (vec) and each step 0 and 81; the peak memory; its first 2
   layers' last-token logits and KV cache against the plain path on the
   CPU at 1 x 512;
4h. Zamba2-7B serving at its full published width (d 3584, d_inner 7168,
   112 SSD heads of 64, state 64, one group; the shared block's 32 heads
   of 112, d_ff 14,336; vocab 32,000) and 32 of its 81 layers, 4 x (6
   Mamba2 blocks + one attention + MLP block whose weights are tied across
   the 4 applications) + 4 Mamba2 blocks, the published plan's two
   segments (all 81 fit the card, but the cut keeps the script's time),
   seeded fp32 weights drawn on the card (2,618,293,440 parameters, the
   reference's count at that depth, or it raises) with every norm scale
   drawn N(1, 0.3): as 4c, a 4 x 2048 prefill into a cache of 2,080 and 32
   decode steps, raising unless each prefill launched exactly 28 scans
   and 4 flash kernels (the shared block's heads of 112, the Hopper form),
   all on the tensor cores, and 65 RMSNorm (56 on Mamba blocks, the
   out_norms at 896 vectors a row among them, 8 on the shared block's
   applications, the final one), all vectorised, and each step no scan
   and 65 RMSNorm; the peak memory; its
   first 14 layers (the shared block applied twice) at a 1 x 320 prefill,
   a chunk of 256 and a ragged one, against the plain path on the CPU:
   the last-token logits, both applications' K/V and every final SSM
   state; a prefill and 5 decode steps under torch.profiler, by kernel
   group; ``ServeEngine`` at the serve launcher's defaults on the same
   weights, 8 requests on 4 slots, so 4 slots are refilled (each cleared
   first);
4i. Command-R 35B serving at its full published width (d 8192, 64 q heads
   over 8 kv heads of 128, d_ff 22,528, vocab 256,000, LayerNorm, the
   parallel block, a tied table) and 20 of its 40 layers (the deepest cut
   whose predicted peak stays under ~70 GB), seeded fp32 weights drawn on
   the card with the LayerNorm scales and biases drawn: as 4c, a 4 x 2048
   prefill into a cache of 2,080 and 32 decode steps, raising unless each
   prefill launched exactly 20 flash kernels, all on the tensor cores
   (causal, 64 q heads over 8 kv heads of 128), and no other kernel, and
   each step none; the peak memory; its first 2 layers against the CPU at
   1 x 512; a prefill and 5 decode steps under torch.profiler;
4j. Qwen2-VL-7B serving at its full published width and depth (28 layers,
   d 3584, 28 q heads over 4 kv heads of 128, d_ff 18,944, vocab 152,064,
   QKV bias, M-RoPE with (t, h, w) sections (16, 24, 24) at theta 1e6),
   seeded fp32 weights drawn on the card (7,615,616,512 parameters, the
   reference's count, or it raises) with the QKV biases drawn nonzero: as
   4c, a 4 x 2048 text prefill into a cache of 2,080 and 32 decode steps,
   then the same prompts with a 1,024-token image each (a 32 x 32 merged
   grid at tokens 64-1087, its (t, h, w) positions built here as Qwen2-VL
   builds them, patch embeddings drawn on the card: the vision encoder is
   a stub, as in the reference) and 32 steps after it, raising unless each
   prefill launched exactly 28 flash kernels, all on the tensor cores, and
   57 RMSNorm, all vectorised, and each step no flash and 57 RMSNorm, and
   unless the image moved the last-token logits; the peak memory; its
   first 2 layers with a 64-token image against the CPU at 1 x 512; a
   prefill and 5 decode steps under torch.profiler; ``ServeEngine`` at the
   serve launcher's defaults on the same weights;
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
8. LM training (every run under remat, the configs' default: where a
   count below says "each way", the forward's layer kernels launch twice
   that, the recompute, and the final norm once): Mamba2-1.3B at its full
   published width, seeded weights drawn on the card, ``make_train_step`` at the train launcher's optimizer (lr
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
   work; then TinyLlama-1.1B training at its full published width and
   depth, seeded fp32 weights drawn on the card, ``make_train_step`` at
   the same optimizer on 2 x 2048 batches, 3 steps after a warm-up (ms a
   step, tokens/s, the losses, all finite, and the peak memory), raising
   unless each step launched exactly 22 flash and 45 RMSNorm kernels
   forward and as many backward, every flash on the tensor cores both ways
   and every norm vectorised both ways; its first 2 layers' gradients at 1
   x 512 held leaf by leaf against the CPU plain path; one step under
   torch.profiler, its device time split into flash forward and backward,
   cuBLAS, RMSNorm, AdamW and the other elementwise work; then
   Gemma-3-27B's training at its full published width on 2 of its 62
   layers, one local and one global (AdamW's new trees take ~28 bytes a
   parameter: 2 layers and the tied table are ~63 GB, one plan segment of
   6 would be ~109 GB), every norm scale drawn N(0, 0.1), 3 steps at 2 x
   2048 after a warm-up, raising unless each step launched 2 flash (1 with
   the window of 1024) and 13 RMSNorm each way, all tc / vec; its 2
   layers' gradients at 1 x 1088, past the window, against the CPU; a
   profiled step; then Qwen1.5-MoE-A2.7B's at its full width on 3 of its
   24 layers (the deepest cut under ~75 GB), QKV biases drawn nonzero, 3
   steps at 2 x 2048, raising unless each step launched a flash each way
   a layer, the routed experts' 2 grouped GEMMs a layer forward and one
   fused backward call each, all on the tensor cores, and 7 RMSNorm each
   way; the (token, k) pairs dropped at capacity; its first 2 layers'
   gradients at 1 x 256 against the CPU, the CPU taking the card's
   experts, with the router's near-ties counted; a profiled step; then
   ``repro_torch.launch.train --smoke`` for 3 steps, again for 3
   resumed ("resumed at step 3") against an uninterrupted 6-step run, and
   ``launch.serve --smoke --ckpt-dir`` serving from its checkpoint; last,
   Mirage's sub-job chain at full width: ``repro_torch.launch.train`` with
   no ``--arch`` (TinyLlama-1.1B, the reference's default) at its defaults,
   8 x 128, a sub-job of 3 steps ending in its exit checkpoint (the
   parameters and AdamW moments, 13.2 GB, through the launcher's own
   writer), a second resumed from it for 2 steps, their losses against an
   uninterrupted 5-step run bit for bit, every flash on the tensor cores
   both ways, each save's and the restore's wall time beside the disk's
   raw write of the same bytes (raising past 60 s, or past 1.5 times the
   raw write where the disk is slower than that) and the host's resident
   set; before the launchers, the donated
   step (``make_train_step(..., donate=True)``, the one ``ChainedTrainer``
   runs, as the reference jits its step with donated params and optimizer
   state): TinyLlama's first 2 layers at full width, one 2 x 2048 step
   functional and donated from the same state, raising unless every leaf
   holds the same bits and every donated leaf kept its storage; then three
   runs through ``ChainedTrainer``'s donated step, each a warm-up and 3
   steps of the trainer's step function with ms a step, tokens/s,
   losses, the peak memory (beside the step's peak counted on meta
   tensors first, ``meta_step_peak``, where it chose the depth) and the
   launches checked: Qwen1.5-4B at full width and depth, all 40 layers,
   fp32 m and v, QKV biases drawn nonzero, 2 x 2048 (a flash launch a
   layer each way, tc; 81 RMSNorm each way, vec);
   HuBERT X-Large at full width and depth (48 layers, heads of 80,
   LayerNorm, bidirectional) on 4 x 1000 frames, after a timed
   ``forward`` and ``loss_fn`` on the same batch (a flash launch a layer
   each, non-causal, in the Hopper form), a flash launch a layer each way
   (the forward twice, remat's recompute), and its first 2 layers'
   gradients against the CPU; DeepSeek-V2
   at full width on 2 of 60 layers (the dense first layer and one MoE
   layer, 5.19 B parameters), bf16 m and v, every norm scale drawn N(1,
   0.3), 1 x 2048 (the routed experts' 2 grouped GEMMs forward and 2
   fused backward calls a step, all tc; 9 RMSNorm each way, vec; no
   flash), the pairs dropped at capacity, its 2 layers' gradients at 1 x
   128 against the CPU with the host's peak memory, and one donated step
   under torch.profiler; Command-R 35B at full width (d 8192, 64 q heads
   over 8 kv heads of 128, d_ff 22,528, the tied 256,000-row table, the
   parallel block, LayerNorm) on 5 of 40 layers, bf16 m and v, every
   LayerNorm scale drawn N(1, 0.3) and bias N(0, 0.3), 2 x 2048 (a flash
   launch a layer each way, tc, the backward's streaming form at one share
   of the group of 8; no RMSNorm), its first 2 layers and the tied head at
   1 x 128 against the CPU with the host's peak memory, and one donated
   step under torch.profiler; Qwen2-VL-7B at full width on 10 of 28 layers,
   fp32 m and v, QKV biases drawn nonzero, 2 x 2048 with a 1,024-token
   image a row (a flash launch a layer each way, tc, the backward's
   streaming form at one share of the group of 7; 21 RMSNorm each way,
   vec), its 2 layers' gradients at 1 x 512 with a 64-token image against
   the CPU; Zamba2-7B at full width on 39 of 81 layers (5 x (6 Mamba2 +
   the tied shared block) + 4 Mamba2), fp32 m and v, every norm scale
   drawn N(1, 0.3), 2 x 2048, raising unless each step launched 34 SSD
   scans each way (tc), 79 RMSNorm each way (vec, the out_norms' 34
   backwards at 896 vectors a row on two warps) and a flash an
   application of the shared block each way (tc, the Hopper form at heads
   of 112, the forward twice with the recompute), and unless the card's
   peak stays at or under 75.90 GB (the depth's budget, which the meta
   count, printed beside it, chose the depth by), with the
   peak memory; a sub-model of 2 Mamba2 blocks each followed by the shared
   block, its gradients at 1 x 512 against the CPU (the tied leaves' the
   sum over both applications); one donated step under torch.profiler by
   kernel group;
8b. the port's four examples (``repro_torch.examples``) on the card at
   the reference examples' defaults: quickstart; train_lm twice on one
   checkpoint directory, raising unless its loss falls both times and the
   second resumes at the first one's step; serve_decode, raising unless
   all 6 requests finish; provision_service (a moe+dqn learner, 3 sub-jobs
   of real payload training chained through checkpoints, a 6-lane sweep),
   raising unless no payload step is lost and the summaries are finite;
8c. remat and the distributed launcher: TinyLlama-1.1B's first 2 layers
   at full width, ``loss_fn``'s gradient on a 2 x 2048 batch with remat
   off and on (the same loss and gradient bits, each way's peak memory and
   ms, the forward kernels' launches twice under remat, the backward's
   once); then ``launch.train --distributed`` at the launcher's defaults
   on a world of one (NCCL, torchrun's variables set by the script; cut
   for time to the model's first 2 layers; every sub-job writes its
   checkpoint through the launcher's own writer),
   a sub-job against the plain launcher's and a second resumed through
   ``restore_checkpoint(shardings=)`` on ``make_host_mesh()`` against a
   plain one resumed from the same checkpoint: the same losses bit for bit;
8d. the dry run's cell ``tinyllama-1.1b x train_4k x 16x16``
   (``repro_torch.launch.dryrun``: a fake process group of 256 and meta
   tensors, on the host), started as a process of its own when the script
   starts so that it runs beside the card's phases, waited for here: its
   ``[ ok ]`` line and its record (memory per device, roofline terms);
5. each kernel's time at the serving paths' shapes (L2 flushed before each
   launch) beside its plain version, the PyTorch library call that
   computes the same function, and the least time the card could take
   (its bound); for every kernel also the variant that ran (by the launch
   counters of the timed calls), the other variant's time at the same shape
   (``simt_ms``: the CUDA-core kernels, and RMSNorm's one element per
   lane), the wrapper's host time per call, and the time without the card's
   lead (the ruler of earlier runs, see ``time_ms``); flash's streaming
   form at a long sequence beside its CUDA-core variant and the library
   call, and at one TinyLlama prefill layer, (4,2048) causal with 32 q
   heads over 4 kv heads, beside its CUDA-core variant, its plain version
   and SDPA with GQA, with its bound (k and v counted at 4 heads); and
   RMSNorm at the decode step's 4 rows; flash at one Qwen2-MoE prefill
   layer, (4,2048,16/16,128) causal; flash at Gemma-3's local prefill
   layer, (4,2048,32/16,128) causal with the window of 1024, beside one
   SDPA call with the band as its mask and ``enable_gqa``, and at its
   global one, causal, beside SDPA with ``enable_gqa``, each with its
   bound (the visible (q, k) pairs' products); RMSNorm as Gemma-3's
   QK-norm runs it, (262144, 128) bf16 with (1 + w), beside ``F.rms_norm``
   with the weight 1 + w; RMSNorm at DeepSeek-V2's q and kv ranks,
   (8192, 1536) and (8192, 512) bf16, beside ``F.rms_norm``; RMSNorm at
   Zamba2-7B's d_model and out_norm, (8192, 3584) and (8192, 7168) bf16,
   and the scan at one of its prefill layers, (4,2048,112,64) with N = 64;
   flash at Command-R's prefill layer, (4,2048,64/8,128) causal, and at
   Qwen2-VL's, (4,2048,28/4,128), beside SDPA with ``enable_gqa``; flash
   both ways at Zamba2-7B's shared block, (4,2048,32/32,112) causal and
   (2,2048,32/32,112) for the backward, and at HuBERT X-Large's layer,
   (4,1000,16/16,80) non-causal, in the Hopper form (on its D = 128
   kernels, ``padded_product_factor``) beside the mma.sync form, SDPA and
   the bound at the head's own D (four records of their own in the JSON
   line, with the launches of those models' paths); the
   grouped
   GEMM at Qwen2-MoE's routed experts' shapes (E = 60: a prefill's 684
   rows an expert and a decode step's 4, through wi and wo) and at
   DeepSeek-V2's (E = 160: 384 rows and 4) beside ``torch.bmm``, each with
   its bound and share; the flash backward at TinyLlama's training shape,
   (2,2048,32/4,64) causal (the streaming form, also at each split count
   of a kv head's q heads, 1, 2, 4 and 8), at Qwen2-VL's (2,2048,28/4,128)
   (one share: no power of two above 1 divides 7), at Qwen2-MoE's,
   (2,2048,16/16,128) causal, and at Gemma-3's local and global training
   layers, (2,2048,32/16,128) causal with and without the window of 1024
   (the local one at 1 and 2 shares), each beside the "simt" kernels
   (``simt_ms``), its plain version, SDPA's backward (with ``enable_gqa``
   where the heads are grouped; with the band as its ``attn_mask`` under
   the window) and its bound; TinyLlama's heads under that window at 1,
   2, 4 and 8 shares (the split rule's measurement); the GEMM backward at
   Qwen2-MoE's training wi and wo shapes and at DeepSeek-V2's (E = 160,
   96 rows an expert) beside two ``torch.bmm``; flash forward and backward
   at Qwen1.5-4B's layer, (4,2048,20/20,128) and (2,2048,20/20,128)
   causal, beside SDPA; RMSNorm's backward over a Gemma-3 layer's 4 block
   norms, at DeepSeek-V2's q and kv norms, (2048,1536) and (2048,512), and
   over a Qwen2-VL layer's 2 block norms, 2 x (4096,3584), and at
   Zamba2-7B's out_norm, (4096,7168), 896 vectors a row, beside the
   "simt" kernel and autograd through ``F.rms_norm``; the SSD backward at
   Zamba2-7B's training layer, x (2,2048,112,64) with N = 64, beside
   "simt" and its plain version (these two Zamba2-7B rows are records of
   their own in the JSON line, their ``launches`` those of the Zamba2-7B
   training run); and the backward kernels
   at the trunk's shapes (flash's at one layer; the GEMM's fused backward
   of one layer's 6 projections beside the earlier two-launch route of the
   same products) beside SDPA's backward and ``torch.bmm``, with the GEMM
   backward's host time split into its parts; and the RMSNorm and SSD
   backward kernels at phase 8's (b) shapes (the fast variant as ``ms``,
   the "simt" one as ``simt_ms``) beside their plain versions and, for
   RMSNorm, autograd through ``F.rms_norm``.

Phases run in the order 1, 2, 3, 4, 4b, 4c, 4d, 4e, 4f, 4g, 4h, 4i, 4j,
6, 7, 8, 8b, 8c, 8d, 5, and each ends with a ``[phase]`` line of its wall
time. Every LM training run goes through remat, as the configs have it:
the forward kernels' counts in its checks include the recompute.
Each kernel's ``launches`` in the JSON record sums the counts of every
path that runs it (phases 3, 4, 4b, 4c's to 4j's prefill and decode
steps, 6, 7, 8: runs (a), (b) and (c), the 2 x 2048 runs of TinyLlama,
Gemma-3 and Qwen2-MoE, the donated step, the ``ChainedTrainer`` runs of
Qwen1.5-4B, HuBERT, DeepSeek-V2, Command-R, Qwen2-VL and Zamba2-7B and the
chain's two sub-jobs at the launcher's defaults, 8b, and 8c's remat run and
four launcher sub-jobs), each
counted from 0 just before its path and read just after.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without a CUDA card the script exits
non-zero before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import resource
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

from repro_torch.configs import (command_r_35b,  # noqa: E402
                                 deepseek_v2_236b, gemma3_27b,
                                 hubert_xlarge, mamba2_1_3b, mirage_agent,
                                 qwen1_5_4b, qwen2_moe_a2_7b, qwen2_vl_7b,
                                 tinyllama_1_1b, zamba2_7b)
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
    WG_HEAD_DIMS, _flash_variant, _launch as flash_launch,
    _launch_bwd as flash_launch_bwd, bwd_splits, bwd_tc_form, fwd_form)
from repro_torch.kernels.moe_gemm import (grouped_gemm,  # noqa: E402
                                          grouped_gemm_bwd_ref,
                                          grouped_gemm_ref)
from repro_torch.kernels.moe_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.moe_gemm.ops import (  # noqa: E402
    _launch as gemm_launch)
from repro_torch.data import DataConfig, data_iterator, synth_batch  # noqa: E402
from repro_torch.examples import (  # noqa: E402
    provision_service as ex_provision, quickstart as ex_quickstart,
    serve_decode as ex_serve_decode, train_lm as ex_train_lm)
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
from repro_torch.analysis.ckpt_stages import (RssPeak,  # noqa: E402
                                              raw_write_s)
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch.dryrun import MetaGenerator  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.blocks import (apply_block,  # noqa: E402
                                       init_block_cache)
from repro_torch.models.layers import apply_norm, lm_logits  # noqa: E402
from repro_torch.models.common import layer_plan  # noqa: E402
from repro_torch.roofline.analysis import StepCounter  # noqa: E402
from repro_torch.serve import (ProvisionService, Request,  # noqa: E402
                               ServeEngine, ServiceConfig)
from repro_torch.sim import (LOAD_LEVELS, PROFILES,  # noqa: E402
                             get_fault_spec, get_scenario, iter_scenarios,
                             make_env, make_vector_env, synthesize_trace)
from repro_torch.train import chain as train_chain  # noqa: E402
from repro_torch.train import checkpoint as ckpt_mod  # noqa: E402
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
PROFILE_TRIES = 3       # profiler sessions before a profile with no device
                        # event fails (CUPTI once handed back none)
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
DENSE = tinyllama_1_1b.CONFIG                # phase 4c
DENSE_NORMS = 2 * DENSE.n_layers + 1        # ln1 and ln2 a layer, final
QWEN = qwen2_moe_a2_7b.CONFIG                # phase 4d
QWEN_NORMS = 2 * QWEN.n_layers + 1
QWEN_GEMMS = 2 * QWEN.n_layers              # the routed experts' wi and wo
QKV_BIAS_STD = 0.5      # the biases drawn nonzero (the reference inits 0)
# phase 4e: Gemma-3-27B at its published width, cut from 62 to 26 layers
# (fp32 weights of all 62, 108 GB, exceed the card's 80): 4 x (5 local +
# 1 global) + 2 local, the published plan's two segments
GEMMA = gemma3_27b.CONFIG.replace(n_layers=26)
GEMMA_LOCAL = sum(seg.n_repeat * seg.pattern.count("local")
                  for seg in layer_plan(GEMMA))
GEMMA_NORMS = 6 * GEMMA.n_layers + 1    # ln1, post_ln1, ln2, post_ln2,
                                        # q_norm, k_norm a layer, final
GEMMA_NORM_STD = 0.1    # the gemma norm scales drawn nonzero (the
                        # reference inits them 0, so (1 + w) would be 1)
GEMMA_PLAIN_PROMPT = 1088   # past the window: the local mask and the
GEMMA_PLAIN_DECODE = 4      # rolled ring bite in the check against the CPU
# phase 4f: DeepSeek-V2-236B at its published width, cut from 60 to 4
# layers, the dense first layer and 3 MoE layers: by their shapes the fp32
# weights of all 60 are ~940 GB and of these 4 (13.14 B parameters) 52.55 GB;
# the prefill's measured peak is in PERF.md §5
DEEPSEEK = deepseek_v2_236b.CONFIG.replace(n_layers=4)
DEEPSEEK_NORMS = 4 * DEEPSEEK.n_layers + 1  # ln1, ln2, q_norm, kv_norm a
                                            # layer, final
DEEPSEEK_GEMMS = 2 * (DEEPSEEK.n_layers - DEEPSEEK.first_k_dense)
DEEPSEEK_NORM_STD = 0.3     # the norm scales drawn N(1, .): the reference
                            # inits them 1, where a swapped q/kv norm hides
DEEPSEEK_PLAIN_PROMPT, DEEPSEEK_PLAIN_DECODE = 256, 2  # within one
                        # latent chunk of 1,024, as 512 was; a prompt of
                        # 256 (not 512) and 2 decode steps (not 4) for the
                        # script's time: each CPU call reads the MoE layer's
                        # 15.9 GB of experts
NEAR_TIE = 1e-5         # a router's K-th and (K+1)-th probabilities this close
LM_REL_TOL = 2e-2       # bf16 model outputs: 2e-2 of the output's largest
                        # magnitude (a few bf16 ulps, as in the CPU tests)
FP32_LM_REL_TOL = 1e-4  # fp32 model outputs (the CPU tests' fp32 bound)
FP32_BWD_REL_TOL = 1e-4  # the RMSNorm and SSD backward kernels against their
BF16_BWD_REL_TOL = 2e-2  # plain versions: of each gradient's largest value
# Mamba2-1.3B training (phase 8): the launcher's optimizer and defaults
TRAIN_OCFG = OptimizerConfig(lr=3e-4, warmup_steps=20, total_steps=10**9)
LM_TRAIN_RUNS = (("a", 8, 128, 5), ("b", 2, 2048, 3))   # batch, seq, steps
DENSE_TRAIN_RUN = ("2 x 2048", 2, 2048, 3)               # TinyLlama's
LM_GRAD_SEQ = 512       # the 2-layer gradient check: 1 x 512, two chunks
# Gemma-3-27B training (phase 8): 2 of its 62 layers, one local and one
# global. AdamW returns new trees, ~28 bytes a parameter at the update: the
# tied table (1.409 B) and 2 layers (0.413 B each) are 2.235 B, ~63 GB;
# one plan segment (6 layers, 3.89 B, ~109 GB) exceeds the card's 80
GEMMA_TRAIN = gemma3_27b.CONFIG.replace(n_layers=2, local_global_period=2)
GEMMA_GRAD_SEQ = 1088   # its gradient check runs past the window of 1024
                        # (1,088, not 2,048, for the script's time)
# Qwen1.5-MoE-A2.7B training (phase 8): the deepest cut under ~75 GB at the
# update, 0.622 B for the embedding and head and 0.571 B a layer
QWEN_TRAIN = qwen2_moe_a2_7b.CONFIG.replace(n_layers=3)
# phase 4g: Qwen1.5-4B at its published width and depth (40 layers, 3.95 B
# parameters, 15.8 GB fp32)
QWEN4B = qwen1_5_4b.CONFIG
QWEN4B_NORMS = 2 * QWEN4B.n_layers + 1
# phase 4h: Zamba2-7B at its published width, cut from 81 to 32 layers, 4 x
# (6 mamba + the shared attention block) + 4 mamba: 28 Mamba blocks, 4
# applications of one tied block. All 81 layers (5.89 B parameters, 23.6 GB
# fp32) fit the card and ran in 4h before; the cut keeps the script's time
# (PERF.md §5)
ZAMBA = zamba2_7b.CONFIG.replace(n_layers=32)
ZAMBA_MAMBA = sum(seg.n_repeat * seg.pattern.count("mamba")
                  for seg in layer_plan(ZAMBA))
ZAMBA_FULL_PARAMS = 5_893_372_128   # the reference's tree at 81 layers and
ZAMBA_MAMBA_PARAMS = 77_978_064     # one Mamba block's, by their shapes
ZAMBA_PARAMS = ZAMBA_FULL_PARAMS - (70 - ZAMBA_MAMBA) * ZAMBA_MAMBA_PARAMS
ZAMBA_ATTN = sum(seg.n_repeat * seg.pattern.count("attn")
                 for seg in layer_plan(ZAMBA))
ZAMBA_NORMS = 2 * ZAMBA_MAMBA + 2 * ZAMBA_ATTN + 1  # ln and out_norm a
                    # Mamba block, ln1 and ln2 an application, the final
ZAMBA_NORM_STD = 0.3    # the norm scales drawn N(1, .) in place of ones
ZAMBA_PLAIN_GROUPS = 2  # its check against the CPU: 14 of the layers, the
ZAMBA_PLAIN_PROMPT = 320    # shared block twice; chunks of 256 and 64
# phase 4i: Command-R 35B at its published width, cut from 40 to 20 layers:
# the deepest cut whose predicted prefill peak stays under ~70 GB (fp32:
# the tied table 8.39 GB and 2.82 GB a layer; PERF.md §4)
CMDR = command_r_35b.CONFIG.replace(n_layers=20)
CMDR_LAYER_PARAMS = 704_675_840     # one layer's, by the reference's shapes
CMDR_PARAMS = 30_284_201_984 - (command_r_35b.CONFIG.n_layers
                                - CMDR.n_layers) * CMDR_LAYER_PARAMS
CMDR_NORM_STD = 0.3     # LayerNorm scales N(1, .) and biases N(0, .)
# its training (phase 8) through ChainedTrainer's donated step, fp32 m and
# v, 16 bytes a parameter with the gradient: whole, all 40 layers, the
# step counted on meta tensors (``meta_step_peak``) at 67.33 GB at 2 x 2048
QWEN4B_TRAIN = qwen1_5_4b.CONFIG
# HuBERT X-Large (phase 8) at its published width and depth: forward, loss
# and training on 4 x 1000 frames (20 s of audio at 50 frames/s)
HUBERT = hubert_xlarge.CONFIG
HUBERT_BATCH, HUBERT_FRAMES = 4, 1000
# DeepSeek-V2-236B training (phase 8): its published width on 2 of 60
# layers, the dense first layer and one MoE layer (5.19 B parameters),
# through ChainedTrainer's donated step with bf16 m and v, as the
# reference's dry run trains it (``BF16_OPT_STATE``): 12 bytes a parameter
# with the fp32 gradient, ~62.3 GB
DEEPSEEK_TRAIN = deepseek_v2_236b.CONFIG.replace(n_layers=2)
DEEPSEEK_TRAIN_OCFG = dataclasses.replace(TRAIN_OCFG, state_dtype="bfloat16")
DEEPSEEK_TRAIN_RUN = ("1 x 2048", 1, 2048, 3)
DEEPSEEK_GRAD_SEQ = 128   # its 2-layer check: the host holds ~42 GB
# Command-R 35B training (phase 8): its published width on 5 of 40 layers
# through ChainedTrainer's donated step with bf16 m and v, the reference's
# dry run's choice for it too (``BF16_OPT_STATE``): 12 bytes a parameter
# with the fp32 gradient, the tied 256,000 x 8,192 table 25.2 GB of them
# and a layer 8.46 GB; the table's gradient one 8.39 GB buffer
# (``layers.TiedTable``). The deepest cut whose step, counted on meta
# tensors (``meta_step_peak``), peaks at or under the 75.90 GB the card
# ran 4 layers at before that buffer: 5 layers 74.90 GB, 6 84.83
CMDR_TRAIN = command_r_35b.CONFIG.replace(n_layers=5)
CMDR_TRAIN_PARAMS = 30_284_201_984 - (command_r_35b.CONFIG.n_layers
                                      - CMDR_TRAIN.n_layers) \
    * CMDR_LAYER_PARAMS
CMDR_GRAD_SEQ = 128     # its 2-layer check: the host holds the tied table
                        # and 2 layers, ~3.5 B fp32 parameters, and their
                        # gradients
# phase 4j: Qwen2-VL-7B at its published width and depth (28 layers, d
# 3584, 28 q heads over 4 kv heads of 128, M-RoPE; 7.62 B parameters, 30.5
# GB fp32)
VL = qwen2_vl_7b.CONFIG
VL_PARAMS = 7_615_616_512       # the reference's tree, by its shapes
VL_NORMS = 2 * VL.n_layers + 1  # ln1 and ln2 a layer, the final
VL_IMAGE = (64, 32, 32)         # a 2048-token prompt's image: its first
                                # token, merged grid rows and columns
VL_PLAIN_IMAGE = (64, 8, 8)     # the 1 x 512 checks' image, 64 tokens
# its training (phase 8) through ChainedTrainer's donated step, fp32 m and
# v, 16 bytes a parameter with the gradient: the deepest cut whose
# predicted peak at 2 x 2048 stays under ~70 GB (the two tables 17.4 GB, a
# layer 3.73 GB, fp32 logits and their gradient ~7.5 GB; PERF.md §4)
VL_TRAIN = VL.replace(n_layers=10)
# Zamba2-7B's training (phase 8) through ChainedTrainer's donated step, fp32
# m and v, 16 bytes a parameter with the gradient: whole groups of (6 Mamba2
# + the shared block) and the 4-block remainder, 5 groups + 4 = 39 layers,
# 34 Mamba blocks (3.09 B parameters, 49.4 GB): the deepest such cut whose
# step, counted on meta tensors (``meta_step_peak``; the flash wrapper
# there allocates the kernels' buffers, no S x S scores), stays at or
# under 75.90 GB (39 layers 74.88 GB, 46 82.37). ``zamba_train`` raises
# if the card's own peak passes ZAMBA_TRAIN_PEAK_GB
ZAMBA_TRAIN = zamba2_7b.CONFIG.replace(n_layers=39)
ZAMBA_TRAIN_PEAK_GB = 75.90
ZAMBA_TRAIN_MAMBA = sum(seg.n_repeat * seg.pattern.count("mamba")
                        for seg in layer_plan(ZAMBA_TRAIN))
ZAMBA_TRAIN_PARAMS = ZAMBA_FULL_PARAMS - (70 - ZAMBA_TRAIN_MAMBA) \
    * ZAMBA_MAMBA_PARAMS
ZAMBA_GRAD_MAMBA = 2    # its gradient check: 2 Mamba blocks, each followed
                        # by the shared block, so 2 applications of it
CHAIN_STEPS = (3, 2)     # the launcher's two sub-jobs at its defaults
CKPT_BUDGET_S = 60.0     # its full-width save and restore, each; or,
CKPT_DISK_FACTOR = 1.5   # where the disk writes the shard slower, this
                         # many times the disk's raw write of its bytes
LAUNCHER_SEQ = 128       # its default tokens a row
TRAIN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_train"
EXAMPLES_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_examples"


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
         ptxas=usage, spills=_spills(logs))


def _spills(logs: dict) -> dict:
    """The kernels whose ``-Xptxas=-v`` report shows spill stores or loads,
    by library: {library: {function: the report's line}}."""
    out = defaultdict(dict)
    for name, log in logs.items():
        fn = None
        for ln in log.splitlines():
            if "Function properties for" in ln:
                fn = ln.split("Function properties for", 1)[1].strip()
            elif "spill" in ln and fn and \
                    "0 bytes spill stores, 0 bytes spill loads" not in ln:
                out[name][fn] = ln.strip()
    return dict(out)


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
    """max|out - ref|, raising where an element is off by more than atol +
    rtol |ref| (``torch.testing.assert_close``); a tensor over 2^28
    elements is compared in slices of its leading axis, since the check's
    fp32 temporaries are several times its size."""
    if out.numel() > 1 << 28 and out.shape[0] > 1:
        step = max(1, out.shape[0] * (1 << 28) // out.numel())
        return max(_err(out[i:i + step], ref[i:i + step], atol, rtol, what)
                   for i in range(0, out.shape[0], step))
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


def _run_variant(kernel, variant: str, name: str, fn, form=None):
    """``fn()``, synchronised, after checking through the kernel's counters
    that it launched once and ran ``variant`` and, for flash's tensor-core
    variant, ``form`` (counted in ``wg_launches`` where it is the Hopper
    streaming form)."""
    n, n_fast = kernel.launches, _fast(kernel)[1]
    n_wg = getattr(kernel, "wg_launches", 0)
    out = fn()
    torch.cuda.synchronize()
    ran = (kernel.launches - n, _fast(kernel)[1] - n_fast)
    if ran != (1, int(variant != "simt")):
        raise RuntimeError(f"{name}: expected one {variant} launch, counted "
                           f"{ran} (launches, {_fast(kernel)[0]} launches)")
    if form is not None and kernel.wg_launches - n_wg != int(form == "wg"):
        raise RuntimeError(f"{name}: expected the {form} form, counted "
                           f"{kernel.wg_launches - n_wg} Hopper-form launches")
    return out


def phase_kernels() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    B = 2 * LANES * mirage_agent.N_EXPERTS
    errs = {}
    # flash: both variants (bf16 on the tensor cores, fp32 on the CUDA
    # cores), every head dim's tensor-core path, q, k, v as strided views
    # of one fused (B, S, 3, H, D) tensor, and every LM layer's shape
    cases = [
        ("flash agent (640,144,8,32) bf16", dict(causal=False),
         (B, HISTORY, HISTORY, 8, 8, 32, torch.bfloat16), "tc", BF16_TOL,
         BF16_TOL, "short"),
        ("flash causal GQA window softcap (2,97|131,8/2,64) bf16",
         dict(causal=True, window=40, softcap=30.0),
         (2, 97, 131, 8, 2, 64, torch.bfloat16), "tc", BF16_TOL, BF16_TOL,
         "wg"),
        ("flash causal GQA window softcap (2,97|131,8/2,64) fp32",
         dict(causal=True, window=40, softcap=30.0),
         (2, 97, 131, 8, 2, 64, torch.float32), "simt", FP32_FLASH_TOL, 0.0,
         None),
        ("flash (3,50,4,16) bf16", dict(causal=False),
         (3, 50, 50, 4, 4, 16, torch.bfloat16), "tc", BF16_TOL, BF16_TOL,
         "short"),
        ("flash causal GQA (2,300,8/2,32) bf16, the mma.sync streaming form",
         dict(causal=True), (2, 300, 300, 8, 2, 32, torch.bfloat16), "tc",
         BF16_TOL, BF16_TOL, "stream"),
        ("flash causal (1,200,4,128) bf16", dict(causal=True),
         (1, 200, 200, 4, 4, 128, torch.bfloat16), "tc", BF16_TOL, BF16_TOL,
         "wg"),
        ("flash fused qkv views (2,77,3,4,64) bf16", dict(causal=True),
         "fused", "tc", BF16_TOL, BF16_TOL, "short"),
        ("flash TinyLlama prefill, causal GQA (4,2048,32/4,64) bf16",
         dict(causal=True), (LM_BATCH, LM_PROMPT, LM_PROMPT, DENSE.nq,
                             DENSE.nkv, DENSE.hd, torch.bfloat16), "tc",
         BF16_TOL, BF16_TOL, "wg"),
        ("flash Qwen2-MoE prefill, causal (4,2048,16/16,128) bf16",
         dict(causal=True), (LM_BATCH, LM_PROMPT, LM_PROMPT, QWEN.nq,
                             QWEN.nkv, QWEN.hd, torch.bfloat16), "tc",
         BF16_TOL, BF16_TOL, "wg"),
        ("flash Qwen1.5-4B prefill, causal (4,2048,20/20,128) bf16",
         dict(causal=True), (LM_BATCH, LM_PROMPT, LM_PROMPT, QWEN4B.nq,
                             QWEN4B.nkv, QWEN4B.hd, torch.bfloat16), "tc",
         BF16_TOL, BF16_TOL, "wg"),
        ("flash Gemma-3 local prefill, causal GQA window 1024 "
         "(4,2048,32/16,128) bf16",
         dict(causal=True, window=GEMMA.sliding_window),
         (LM_BATCH, LM_PROMPT, LM_PROMPT, GEMMA.nq, GEMMA.nkv, GEMMA.hd,
          torch.bfloat16), "tc", BF16_TOL, BF16_TOL, "wg"),
        ("flash Gemma-3 global prefill, causal GQA (4,2048,32/16,128) bf16",
         dict(causal=True), (LM_BATCH, LM_PROMPT, LM_PROMPT, GEMMA.nq,
                             GEMMA.nkv, GEMMA.hd, torch.bfloat16), "tc",
         BF16_TOL, BF16_TOL, "wg"),
        ("flash Gemma-3 ragged, causal GQA window 1024 (2,1100,32/16,128) "
         "bf16", dict(causal=True, window=GEMMA.sliding_window),
         (2, 1100, 1100, GEMMA.nq, GEMMA.nkv, GEMMA.hd, torch.bfloat16),
         "tc", BF16_TOL, BF16_TOL, "wg"),
        ("flash Command-R prefill, causal GQA (4,2048,64/8,128) bf16",
         dict(causal=True), (LM_BATCH, LM_PROMPT, LM_PROMPT, CMDR.nq,
                             CMDR.nkv, CMDR.hd, torch.bfloat16), "tc",
         BF16_TOL, BF16_TOL, "wg"),
        ("flash Qwen2-VL prefill, causal GQA (4,2048,28/4,128) bf16",
         dict(causal=True), (LM_BATCH, LM_PROMPT, LM_PROMPT, VL.nq,
                             VL.nkv, VL.hd, torch.bfloat16), "tc",
         BF16_TOL, BF16_TOL, "wg"),
        # the two layers whose heads the Hopper form runs on its D = 128
        # kernels; phase 5's records at them carry these errors
        (ZAMBA_FLASH_CASE, dict(causal=True),
         (LM_BATCH, LM_PROMPT, LM_PROMPT, ZAMBA.nq, ZAMBA.nkv, ZAMBA.hd,
          torch.bfloat16), "tc", BF16_TOL, BF16_TOL, "wg"),
        (HUBERT_FLASH_CASE, dict(causal=False),
         (HUBERT_BATCH, HUBERT_FRAMES, HUBERT_FRAMES, HUBERT.nq, HUBERT.nkv,
          HUBERT.hd, torch.bfloat16), "tc", BF16_TOL, BF16_TOL, "wg"),
        # rows whose block's first kv tiles are all outside the window, at
        # a scale whose rounding once made their exponents inf
        ("flash causal GQA window 1024 (1,2048,8/4,64) bf16",
         dict(causal=True, window=GEMMA.sliding_window),
         (1, 2048, 2048, 8, 4, 64, torch.bfloat16), "tc", BF16_TOL,
         BF16_TOL, "wg"),
    ]
    for name, opts, shape, variant, atol, rtol, form in cases:
        if shape == "fused":
            q, k, v = _randn(gen, (2, 77, 3, 4, 64), torch.bfloat16).unbind(2)
        else:
            q, k, v = flash_inputs(gen, *shape)
        if variant == "tc" and fwd_form(q.shape[1], k.shape[1],
                                        q.shape[3]) != form:
            raise RuntimeError(f"{name}: fwd_form says "
                               f"{fwd_form(q.shape[1], k.shape[1], q.shape[3])}")
        out = _run_variant(flash_attention, variant, name,
                           lambda: flash_attention(q, k, v, **opts), form)
        err = _err(out, flash_attention_ref(q, k, v, **opts), atol, rtol, name)
        errs["flash_attention"] = max(errs.get("flash_attention", 0.0), err)
        errs.setdefault("flash_case", {})[name] = err
        if form == "wg":
            errs["flash_attention_wg"] = max(
                errs.get("flash_attention_wg", 0.0), err)
        line("check", case=name, variant=variant, form=form, max_abs_err=err,
             atol=atol, rtol=rtol)
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
    # the Qwen2-MoE routed experts: a 4 x 2048 prefill's 684 rows an expert
    # (C = 171 a row of the batch) through wi and wo, a decode step's 4
    cases += [(f"gemm Qwen2-MoE {what} ({QWEN.n_experts},{c},{a})x("
               f"{QWEN.n_experts},{a},{b}) bf16",
               (QWEN.n_experts, c, a, b, torch.bfloat16), "tc", BF16_TOL)
              for what, c, a, b in _moe_gemm_shapes()[:3]]
    # DeepSeek-V2's: 160 experts, a prefill's 384 rows an expert (C = 96 a
    # row of the batch) and a decode step's 4, through wi and wo
    cases += [(f"gemm DeepSeek-V2 {what} ({DEEPSEEK.n_experts},{c},{a})x("
               f"{DEEPSEEK.n_experts},{a},{b}) bf16",
               (DEEPSEEK.n_experts, c, a, b, torch.bfloat16), "tc", BF16_TOL)
              for what, c, a, b in _moe_gemm_shapes(DEEPSEEK)]
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
        # Gemma-3's (1 + w): QK-norm over a 4 x 2048 prefill's 32 q heads
        # of 128, and its d_model (672 vectors a row)
        ("rmsnorm Gemma-3 QK-norm (262144,128) bf16 gemma",
         (LM_BATCH * LM_PROMPT * GEMMA.nq, GEMMA.hd, torch.bfloat16), True,
         "plain", "vec", BF16_TOL),
        ("rmsnorm Gemma-3 (8192,5376) bf16 gemma",
         (LM_BATCH * LM_PROMPT, GEMMA.d_model, torch.bfloat16), True,
         "plain", "vec", BF16_TOL),
        # DeepSeek-V2's q_norm and kv_norm over a 4 x 2048 prefill
        ("rmsnorm DeepSeek-V2 q_norm (8192,1536) bf16",
         (LM_BATCH * LM_PROMPT, DEEPSEEK.q_lora_rank, torch.bfloat16), False,
         "plain", "vec", BF16_TOL),
        ("rmsnorm DeepSeek-V2 kv_norm (8192,512) bf16",
         (LM_BATCH * LM_PROMPT, DEEPSEEK.kv_lora_rank, torch.bfloat16),
         False, "plain", "vec", BF16_TOL),
        # Zamba2-7B's d_model and its out_norm's d_inner, 896 vectors a row
        # (the vec forward's limit), at a prefill and a decode step; one
        # vector more runs simt
        ("rmsnorm Zamba2-7B (8192,3584) bf16",
         (LM_BATCH * LM_PROMPT, ZAMBA.d_model, torch.bfloat16), False,
         "plain", "vec", BF16_TOL),
        ("rmsnorm Zamba2-7B out_norm (8192,7168) bf16",
         (LM_BATCH * LM_PROMPT, ZAMBA.d_inner, torch.bfloat16), False,
         "plain", "vec", BF16_TOL),
        ("rmsnorm Zamba2-7B out_norm decode (4,7168) bf16",
         (LM_BATCH, ZAMBA.d_inner, torch.bfloat16), False, "plain", "vec",
         BF16_TOL),
        ("rmsnorm (33,7176) bf16, 897 vectors",
         (33, ZAMBA.d_inner + 8, torch.bfloat16), False, "plain", "simt",
         BF16_TOL),
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
        ("ssd Zamba2-7B prefill (4,2048,112,64) N=64 G=1 chunk 256 bf16",
         (LM_BATCH, LM_PROMPT, ZAMBA.ssm_nheads, ZAMBA.ssm_headdim,
          ZAMBA.ssm_state, ZAMBA.ssm_ngroups, torch.bfloat16, False),
         ZAMBA.ssm_chunk, "tc", BF16_TOL, BF16_TOL),
        ("ssd ragged (1,1100,112,64) N=64 chunk 256 bf16, initial state",
         (1, 1100, ZAMBA.ssm_nheads, ZAMBA.ssm_headdim, ZAMBA.ssm_state, 1,
          torch.bfloat16, True), ZAMBA.ssm_chunk, "tc", BF16_TOL, BF16_TOL),
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
    check_head_dims(gen, errs)
    return errs


def _bwd_counts():
    return (flash_attention_bwd.launches, grouped_gemm.bwd_launches,
            grouped_gemm.bwd_tc_launches, flash_attention_bwd.tc_launches,
            flash_attention_bwd.wg_launches)


# the Hopper streaming flash backward's shares of a kv head's q heads
# (``bwd_splits``) on an H100's 132 SMs, 128 kv rows a dkdv block:
# Command-R's 256 blocks at 2 x 2048 take one, its 128 at 1 x 2048 two,
# Qwen2-VL's 128 two of its group of 7 (3 and 4 q heads; fp32 partials
# summed by a last pass)
FLASH_BWD_SHARES = {
    "flash bwd Command-R training (2,2048,64/8,128) bf16, a group of 8": 1,
    "flash bwd Command-R heads at a batch of 1 (1,2048,64/8,128) bf16": 2,
    "flash bwd Qwen2-VL training (2,2048,28/4,128) bf16, a group of 7": 2}


def check_backward(gen, errs: dict) -> None:
    """The backward kernels through autograd, as training runs them, against
    their plain versions on the same inputs. Flash: the forward keeps each
    row's log-sum-exp (held against the plain one), and dq, dk, dv of one
    backward launch of the variant named are held against
    ``flash_attention_bwd_ref`` on the forward's out; the tensor-core
    variant in its short form at every head dim it takes (the trunk's MHA
    heads), causal, softcap and ragged, and in its Hopper streaming form
    (wgmma fed by TMA, D = 64 and 128; the counters show the form) for
    GQA, D = 128, long sequences and the LM training layers (TinyLlama's
    (2,2048,32/4,64), Qwen2-MoE's heads at (2,1024,16/16,128), Gemma-3's
    local and global ones at (2,2048,32/16,128), Command-R's
    (2,2048,64/8,128) at one share of a kv head's 8 q heads and, at a
    batch of 1, two, Qwen2-VL's group of 7 at two, each share count held
    to FLASH_BWD_SHARES; Zamba2-7B's shared block at (2,2048,32/32,112)
    and HuBERT X-Large's non-causal (4,1000,16/16,80), the form on its D =
    128 kernels), its mma.sync streaming form at D = 32; with a
    window in every
    form: 1024 at S 2048, 1000 (no multiple of 64) at a ragged S of 2050,
    48 (under one tile), GQA 32/16 and 8/4, D 64 and 128, the short form at
    S 144 with 64, fp32 on the CUDA cores; each "tc" case also through
    "simt" on the same inputs, held to the same bound; every case twice
    more through its variant, the same bit for bit; the CUDA-core variant
    for fp32. The GEMM: dX
    and dW against ``grouped_gemm_bwd_ref``, in bf16 from one launch of the
    fused backward kernel (counted once in ``bwd_fused_calls``; dW split
    along C and the same bit for bit over two more calls), with x or dY
    strided as the trunk stores its activations, and at Qwen2-MoE's
    training shapes (E = 60, 342 rows an expert at 2 x 2048 tokens, wi and
    wo); in fp32 from two launches of the CUDA-core kernel. At each bf16
    case the two-launch route that phase 5 times beside it is held to the
    same tolerance."""
    B = 2 * LANES * mirage_agent.N_EXPERTS
    bf16 = torch.bfloat16
    causal, cap, both = (dict(causal=True, softcap=0.0),
                         dict(causal=False, softcap=30.0),
                         dict(causal=True, softcap=30.0))

    def band(window):
        return dict(causal=True, softcap=0.0, window=window)
    cases = [
        ("flash bwd agent (640,144,8,32) bf16", dict(causal=False,
                                                     softcap=0.0),
         (B, HISTORY, HISTORY, 8, 8, 32, bf16), "tc"),
        ("flash bwd softcap (3,50,4,16) bf16", cap, (3, 50, 50, 4, 4, 16, bf16),
         "tc"),
        ("flash bwd causal softcap (2,97|131,4,64) bf16", both,
         (2, 97, 131, 4, 4, 64, bf16), "tc"),
        ("flash bwd fused qkv views (2,77,3,4,64) bf16", causal, "fused",
         "tc"),
        ("flash bwd causal GQA (1,300,8/2,32) bf16, the mma.sync streaming "
         "form", causal, (1, 300, 300, 8, 2, 32, bf16), "tc"),
        ("flash bwd causal GQA ragged (2,1001,8/2,64) bf16", causal,
         (2, 1001, 1001, 8, 2, 64, bf16), "tc"),
        ("flash bwd causal softcap GQA (1,200,4/2,128) bf16", both,
         (1, 200, 200, 4, 2, 128, bf16), "tc"),
        ("flash bwd TinyLlama training (2,2048,32/4,64) bf16", causal,
         (2, LM_PROMPT, LM_PROMPT, DENSE.nq, DENSE.nkv, DENSE.hd, bf16),
         "tc"),
        ("flash bwd Qwen2-MoE heads (2,1024,16/16,128) bf16", causal,
         (2, 1024, 1024, QWEN.nq, QWEN.nkv, QWEN.hd, bf16), "tc"),
        ("flash bwd Qwen1.5-4B training (2,2048,20/20,128) bf16", causal,
         (2, LM_PROMPT, LM_PROMPT, QWEN4B.nq, QWEN4B.nkv, QWEN4B.hd, bf16),
         "tc"),
        ("flash bwd Qwen2-VL training (2,2048,28/4,128) bf16, a group of 7",
         causal, (2, LM_PROMPT, LM_PROMPT, VL.nq, VL.nkv, VL.hd, bf16), "tc"),
        ("flash bwd Command-R training (2,2048,64/8,128) bf16, a group of 8",
         causal, (2, LM_PROMPT, LM_PROMPT, CMDR.nq, CMDR.nkv, CMDR.hd, bf16),
         "tc"),
        ("flash bwd Command-R heads at a batch of 1 (1,2048,64/8,128) bf16",
         causal, (1, LM_PROMPT, LM_PROMPT, CMDR.nq, CMDR.nkv, CMDR.hd, bf16),
         "tc"),
        (ZAMBA_FLASH_BWD_CASE, causal,
         (2, LM_PROMPT, LM_PROMPT, ZAMBA_TRAIN.nq, ZAMBA_TRAIN.nkv,
          ZAMBA_TRAIN.hd, bf16), "tc"),
        (HUBERT_FLASH_BWD_CASE, dict(causal=False, softcap=0.0),
         (HUBERT_BATCH, HUBERT_FRAMES, HUBERT_FRAMES, HUBERT.nq, HUBERT.nkv,
          HUBERT.hd, bf16), "tc"),
        ("flash bwd causal GQA softcap (2,97|131,8/2,64) fp32", both,
         (2, 97, 131, 8, 2, 64, torch.float32), "simt"),
        ("flash bwd Gemma-3 global training (2,2048,32/16,128) bf16", causal,
         (2, LM_PROMPT, LM_PROMPT, GEMMA.nq, GEMMA.nkv, GEMMA.hd, bf16), "tc"),
        ("flash bwd Gemma-3 local training (2,2048,32/16,128) window 1024 "
         "bf16", band(GEMMA.sliding_window),
         (2, LM_PROMPT, LM_PROMPT, GEMMA.nq, GEMMA.nkv, GEMMA.hd, bf16), "tc"),
        ("flash bwd GQA 8/4 (1,2048,8/4,64) window 1024 bf16", band(1024),
         (1, 2048, 2048, 8, 4, 64, bf16), "tc"),
        ("flash bwd ragged (1,2050,8/4,64) window 1000 bf16", band(1000),
         (1, 2050, 2050, 8, 4, 64, bf16), "tc"),
        ("flash bwd (1,300,4/2,128) window 48, under a tile, bf16", band(48),
         (1, 300, 300, 4, 2, 128, bf16), "tc"),
        ("flash bwd short form (2,144,4/4,64) window 64 bf16", band(64),
         (2, 144, 144, 4, 4, 64, bf16), "tc"),
        ("flash bwd (1,300,4/2,64) window 100 fp32", band(100),
         (1, 300, 300, 4, 2, 64, torch.float32), "simt"),
    ]
    for name, opts, shape, variant in cases:
        opts = dict(opts, window=opts.get("window", 0))
        atol, rtol = ((BF16_TOL, BF16_TOL) if variant == "tc" else
                      (FP32_FLASH_TOL, FP32_FLASH_BWD_RTOL))
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
        form = (bwd_tc_form(q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                            q.shape[3]) if variant == "tc" else None)
        if (after[0] - before[0], after[3] - before[3],
                after[4] - before[4]) != (1, int(variant == "tc"),
                                          int(form == "wg")):
            raise RuntimeError(f"{name}: expected one {variant} backward "
                               f"launch ({form}), counted {before} -> {after}")
        if form not in (None, "short") and \
                (form == "wg") != (q.shape[3] in WG_HEAD_DIMS):
            raise RuntimeError(f"{name}: the {form} form at D {q.shape[3]}")
        q, k, v, out = (t.detach() for t in (q, k, v, out))
        if shape == "fused":
            grads = grads[0].unbind(2)
        _, lse = flash_launch(q, k, v, _flash_variant(q, k, v),
                              scale=q.shape[3] ** -0.5, lse=True, **opts)
        lse_err = _err(lse, flash_attention_lse_ref(q, k, **opts), LSE_ATOL,
                       1e-5, name + " lse")
        refs = flash_attention_bwd_ref(q, k, v, out, lse, do, **opts)
        err = max(_err(g, r, atol, rtol, f"{name} d{n}")
                  for n, g, r in zip("qkv", grads, refs))
        errs["flash_attention_bwd"] = max(
            errs.get("flash_attention_bwd", 0.0), err)
        errs.setdefault("flash_bwd_case", {})[name] = err
        extra = {"window": opts["window"]}
        # launches that compare, not counted: the variant again, bit for
        # bit, and for "tc" the "simt" kernels on the same inputs
        run = dict(opts, scale=q.shape[3] ** -0.5)
        dout = do.contiguous()
        for _ in range(2):
            again = flash_launch_bwd(q, k, v, out, lse, dout, variant, **run)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise RuntimeError(f"{name}: dq, dk, dv differ between calls")
        extra["bit_identical"] = True
        del again
        if variant == "tc":
            Hq, Hkv = q.shape[2], k.shape[2]
            extra["form"] = form
            if form == "wg":
                errs["flash_attention_bwd_wg"] = max(
                    errs.get("flash_attention_bwd_wg", 0.0), err)
            if form != "short":
                extra["splits"] = bwd_splits(
                    q.shape[0], k.shape[1], Hkv, Hq // Hkv,
                    torch.cuda.get_device_properties(0).multi_processor_count,
                    form)
                want = FLASH_BWD_SHARES.get(name)
                if want is not None and extra["splits"] != want:
                    raise RuntimeError(f"{name}: {extra['splits']} shares, "
                                       f"not {want}")
            simt = flash_launch_bwd(q, k, v, out, lse, dout, "simt", **run)
            extra["simt_max_abs_err"] = max(
                _err(g, r, atol, rtol, f"{name} simt d{n}")
                for n, g, r in zip("qkv", simt, refs))
            del simt
        line("check", case=name, variant=variant, max_abs_err=err,
             lse_max_abs_err=lse_err, atol=atol, rtol=rtol, **extra)
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
               (3, 1001, 200, 136, bf16), "plain", BF16_TOL)]
    # the routed experts' wi and wo at Qwen2-MoE's 2 x 2048 training batch
    # and DeepSeek-V2's 1 x 2048 (96 rows an expert, a k-tail of 32 in dW's
    # contraction)
    cases += [(f"gemm bwd {model} training {what} ({E},{C},{a})x"
               f"({E},{a},{b}) bf16", (E, C, a, b, bf16), "plain", BF16_TOL)
              for model, cfg, batch in MOE_TRAIN_GEMMS
              for what, E, C, a, b in _moe_train_gemms(cfg, batch)]
    cases += [("gemm bwd ragged (3,1001,200)x(3,200,136) fp32",
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


# phase 2's cases at the two layers whose heads the Hopper form pads, each
# at the shape its path gives the kernel: Zamba2-7B's shared block at a
# prefill (phase 4h) and a training step (phase 8), HuBERT X-Large's
# encoder layer at its 4 x 1000 frames both ways (phase 8)
ZAMBA_FLASH_CASE = ("flash Zamba2-7B shared block prefill, causal "
                    "(4,2048,32/32,112) bf16")
HUBERT_FLASH_CASE = "flash HuBERT X-Large layer, non-causal (4,1000,16/16,80) bf16"
ZAMBA_FLASH_BWD_CASE = ("flash bwd Zamba2-7B shared block training "
                        "(2,2048,32/32,112) bf16")
HUBERT_FLASH_BWD_CASE = ("flash bwd HuBERT X-Large training, non-causal "
                         "(4,1000,16/16,80) bf16")


# the head dims the tensor-core variant takes besides 16, 32, 64 and 128
# (HuBERT X-Large's 80, Zamba2-7B's 112), and one only the CUDA-core
# variant takes
NEW_HEAD_DIMS = (48, 80, 96, 112)
SIMT_HEAD_DIM = 72


# flash's counters both ways, by their ``_lm_train_counts`` names
FLASH_COUNTS = ("flash_attention", "flash_tc", "flash_wg",
                "flash_attention_bwd", "flash_bwd_tc", "flash_bwd_wg")


def check_head_dims(gen, errs: dict) -> None:
    """Flash at the head dims 48, 80, 96 and 112 (the Hopper form on its D
    = 64 or 128 kernels, the columns past D read as zeros; the mma.sync
    forms at D itself) and at 72, which only the CUDA-core variant takes.
    Each case runs through autograd as training does, its launches counted
    both ways (the variant, and the form ``fwd_form`` / ``bwd_tc_form``
    name), against the plain versions: out, the row log-sum-exp, dq, dk,
    dv; each bf16 case at a tensor-core head dim then runs every other
    form its shapes take, named, on the same inputs both ways (launches
    that compare, not counted). Cases: causal GQA 8/2 at ragged 97|131
    with a window of 40 and softcap (the short forms at 48, the Hopper
    form past it), causal GQA 8/2 at a ragged 333 (the Hopper form), MHA
    4/4 at 64 non-causal (the forward's short form), each in bf16, and the
    first in fp32 (CUDA cores); at 72 the first in both dtypes."""
    cases = []
    for D in NEW_HEAD_DIMS + (SIMT_HEAD_DIM,):
        cases += [((2, 97, 131, 8, 2, D, dt), dict(causal=True, window=40,
                                                   softcap=30.0))
                  for dt in (torch.bfloat16, torch.float32)]
        if D in NEW_HEAD_DIMS:
            cases += [((2, 333, 333, 8, 2, D, torch.bfloat16),
                       dict(causal=True, window=0, softcap=0.0)),
                      ((2, 64, 64, 4, 4, D, torch.bfloat16),
                       dict(causal=False, window=0, softcap=0.0))]
    for shape, opts in cases:
        B, Sq, Skv, Hq, Hkv, D, dtype = shape
        name = (f"flash head dim {D} ({B},{Sq}|{Skv},{Hq}/{Hkv}) "
                f"{str(dtype)[6:]}, causal {opts['causal']}, window "
                f"{opts['window']}, softcap {opts['softcap']}")
        leaves = [t.requires_grad_(True)
                  for t in flash_inputs(gen, B, Sq, Skv, Hq, Hkv, D, dtype)]
        q, k, v = (t.detach() for t in leaves)
        do = _randn(gen, q.shape, dtype)
        variant = "tc" if dtype == torch.bfloat16 and D % 16 == 0 else "simt"
        tc = variant == "tc"
        form = fwd_form(Sq, Skv, D) if tc else None
        bwd_form = bwd_tc_form(Sq, Skv, Hq, Hkv, D) if tc else None
        before = _lm_train_counts()
        out = flash_attention(*leaves, **opts)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        after = _lm_train_counts()
        got = tuple(after[n] - before[n] for n in FLASH_COUNTS)
        want = (1, int(tc), int(form == "wg"), 1, int(tc),
                int(bwd_form == "wg"))
        if got != want:
            raise RuntimeError(f"{name}: launched {got} (launches, tc, wg "
                               f"forward then backward), not {want}")
        out = out.detach()
        atol, rtol, brtol = ((BF16_TOL, BF16_TOL, BF16_TOL) if tc or
                             dtype == torch.bfloat16 else
                             (FP32_FLASH_TOL, 0.0, FP32_FLASH_BWD_RTOL))
        ref = flash_attention_ref(q, k, v, **opts)
        run = dict(opts, scale=D ** -0.5)
        _, lse = flash_launch(q, k, v, variant, lse=True, **run)
        lse_ref = flash_attention_lse_ref(q, k, **opts)
        refs = flash_attention_bwd_ref(q, k, v, out, lse_ref, do, **opts)
        err = _err(out, ref, atol, rtol, name)
        lse_err = _err(lse, lse_ref, LSE_ATOL, 1e-5, name + " lse")
        bwd_err = max(_err(g, r, atol, brtol, f"{name} d{n}")
                      for n, g, r in zip("qkv", grads, refs))
        named = {}
        if tc:
            forms = ["stream", "wg"] + ["short"] * (form == "short")
            for f in forms:
                o_f, lse_f = flash_launch(q, k, v, "tc", lse=True, form=f,
                                          **run)
                named[f"fwd_{f}"] = max(
                    _err(o_f, ref, atol, rtol, f"{name} {f} out"),
                    _err(lse_f, lse_ref, LSE_ATOL, 1e-5, f"{name} {f} lse"))
            forms = ["stream", "wg"] + ["short"] * (bwd_form == "short")
            for f in forms:
                g_f = flash_launch_bwd(q, k, v, out, lse_ref, do.contiguous(),
                                       "tc", form=f, **run)
                named[f"bwd_{f}"] = max(
                    _err(g, r, atol, brtol, f"{name} {f} d{n}")
                    for n, g, r in zip("qkv", g_f, refs))
        for key, e in (("flash_attention", max([err] + [
                           e for f, e in named.items() if f[:3] == "fwd"])),
                       ("flash_attention_bwd", max([bwd_err] + [
                           e for f, e in named.items() if f[:3] == "bwd"]))):
            errs[key] = max(errs.get(key, 0.0), e)
        line("check", case=name, head_dim=D, variant=variant, form=form,
             bwd_form=bwd_form, max_abs_err=err, lse_max_abs_err=lse_err,
             bwd_max_abs_err=bwd_err, named_forms_max_abs_err=named,
             atol=atol, rtol=rtol)
        del leaves, q, k, v, do, out, grads, ref, refs


def _err_scale(out, ref, what) -> tuple:
    """(max|out - ref|, max|ref|) on the host: ``out`` copied there once
    and differenced in place, ``ref`` read once (a few passes over a
    multi-GB gradient, where the host's memory sets the time). A NaN or
    inf in ``out`` makes the error non-finite, and that raises."""
    ref = ref.detach().to("cpu", torch.float32)
    diff = out.detach().to("cpu", torch.float32, copy=True)
    if diff.shape != ref.shape:
        raise RuntimeError(f"{what}: bad output {diff.shape} vs {ref.shape}")
    err = diff.sub_(ref).abs_().max().item()
    lo, hi = torch.aminmax(ref)
    scale = max(-lo.item(), hi.item())
    if not np.isfinite(err):
        raise RuntimeError(f"{what}: bad output, max|out - ref| = {err}")
    return err, scale


def _within(what, err: float, scale: float, tol: float) -> None:
    if err > tol * scale:
        raise RuntimeError(f"{what}: kernel path off the plain path by {err}"
                           f" (scale {scale}, tolerance {tol} of it)")


def _rel_err(out, ref, what, tol=LM_REL_TOL) -> float:
    """max|out - ref|, raising unless within ``tol`` of ref's largest
    magnitude."""
    err, scale = _err_scale(out, ref, what)
    _within(what, err, scale, tol)
    return err


def check_lm_backward(gen, errs: dict) -> None:
    """The RMSNorm and SSD backward kernels through autograd, as Mamba2
    training runs them (RMSNorm also at Gemma-3's block norms, 672
    vectors a row with gemma, and at Zamba2-7B's out_norm, 896 vectors, two
    warps a row, with an fp32 or a bf16 w, and at its d_model in fp32, 896
    vectors of 4, and 897, "simt"; the scan also at Zamba2-7B's 112 heads of
    64 with N = 64), against their plain versions on the same
    inputs (fp32 1e-4, bf16 2e-2 of each gradient's largest value): one forward
    and one backward launch each, of the variant the case names (counted:
    "vec" / "tc" for bf16 rows and chunks they can address), and the
    reductions (RMSNorm's dw; the scan's dA, dB, dC, dD) the same bit for
    bit over two more calls (RMSNorm's dx too); where that variant is the
    fast one, the other ("simt") on the same inputs, held to the same
    bound."""
    bf16, f32 = torch.bfloat16, torch.float32
    d, din = LM.d_model, LM.d_inner
    cases = [(f"rmsnorm bwd ({r},{c}) bf16, w fp32", r, c, bf16, False, "vec")
             for r, c in ((8 * 128, d), (2 * 2048, d), (2 * 2048, din))]
    cases += [("rmsnorm bwd (4096,2048) bf16 gemma", 4096, d, bf16, True,
               "vec"),
              ("rmsnorm bwd Gemma-3's block norms (4096,5376) bf16 gemma, "
               "672 vectors", 4096, GEMMA.d_model, bf16, True, "vec"),
              ("rmsnorm bwd DeepSeek-V2 q_norm (2048,1536) bf16, 192 "
               "vectors", LM_PROMPT, DEEPSEEK.q_lora_rank, bf16, False,
               "vec"),
              ("rmsnorm bwd DeepSeek-V2 kv_norm (2048,512) bf16, 64 vectors",
               LM_PROMPT, DEEPSEEK.kv_lora_rank, bf16, False, "vec"),
              ("rmsnorm bwd Qwen2-VL's block norms (4096,3584) bf16, 448 "
               "vectors", 2 * LM_PROMPT, VL.d_model, bf16, False, "vec"),
              ("rmsnorm bwd Zamba2's out_norm (4096,7168) bf16, 896 "
               "vectors, two warps a row", 2 * LM_PROMPT, ZAMBA.d_inner, bf16,
               False, "vec"),
              ("rmsnorm bwd (4096,7168) bf16 gemma, 896 vectors", 2 * LM_PROMPT,
               ZAMBA.d_inner, bf16, True, "vec"),
              ("rmsnorm bwd ragged (37,7168) bf16, 896 vectors", 37,
               ZAMBA.d_inner, bf16, False, "vec"),
              ("rmsnorm bwd (4096,7168) bf16, w bf16, 896 vectors",
               2 * LM_PROMPT, ZAMBA.d_inner, bf16, False, "vec", bf16),
              ("rmsnorm bwd (4096,3584) fp32, 896 vectors, two warps a row",
               2 * LM_PROMPT, ZAMBA.d_model, f32, False, "vec"),
              ("rmsnorm bwd (37,7176) bf16, 897 vectors: past the vec form",
               37, ZAMBA.d_inner + 8, bf16, False, "simt"),
              ("rmsnorm bwd (4096,4096) fp32, past the vectors", 4096, din,
               f32, False, "simt"),
              ("rmsnorm bwd ragged (37,2048) fp32 gemma", 37, d, f32, True,
               "vec"),
              ("rmsnorm bwd (37,300) bf16, d off 8", 37, 300, bf16, False,
               "simt"),
              ("rmsnorm bwd (33,300) fp32 gemma", 33, 300, f32, True, "vec")]
    for name, rows, dim, dtype, gemma, variant, *w_dtype in cases:
        x = _randn(gen, (rows, dim), dtype, 3.0).requires_grad_(True)
        w = (1.0 + 0.1 * _randn(gen, (dim,), f32)).to(*w_dtype or [f32])
        w.requires_grad_(True)
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
            again = norm_launch_bwd(xd, wd, dy, variant, eps=LM.norm_eps,
                                    gemma=gemma)
            if not (torch.equal(again[0], dx) and torch.equal(again[1], dw)):
                raise RuntimeError(f"{name}: dx or dw differs between calls")
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
        del x, w, dy, dx, dw, rdx, rdw, xd, wd, again
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
        ("ssd bwd Zamba2's training layer (2,2048,112,64) N=64 G=1 chunk 256 "
         "bf16", (2, 2048, ZAMBA.ssm_nheads, P, ZAMBA.ssm_state, 1, bf16,
                  False), 256, False),
        ("ssd bwd ragged (1,300,112,64) N=64 G=1 chunk 256 bf16, initial "
         "state and d_final", (1, 300, ZAMBA.ssm_nheads, P, ZAMBA.ssm_state,
                               1, bf16, True), 256, True),
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


def _profiled(fn) -> tuple:
    """One call of ``fn()`` under torch.profiler: its host wall in us and
    the profiler's device (CUDA) events."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return wall_us, [e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_device(what: str, fn, units: int, unit: str, warmup: int = 1,
                   **meta) -> dict:
    """``fn()`` under torch.profiler, after ``warmup`` calls: host wall
    time per ``unit`` (``fn`` does ``units`` of them), the share of the
    wall the card was busy (the union of kernel intervals), and device time
    per kernel name, largest first. A session in which CUPTI handed back no
    device event at all is run again, up to PROFILE_TRIES sessions."""
    for _ in range(warmup):
        fn()
    for attempt in range(1, PROFILE_TRIES + 1):
        wall_us, events = _profiled(fn)
        if events:
            break
        line("profile_retry", what=what, attempt=attempt,
             reason="the profiler recorded no device activity")
    else:
        raise RuntimeError(f"the profiler recorded no device activity in "
                           f"{PROFILE_TRIES} sessions of {what}")
    per_name, intervals = defaultdict(lambda: [0, 0.0]), []
    for e in events:
        t_start, t_end = e.time_range.start, e.time_range.end
        intervals.append((t_start, t_end))
        per_name[e.name][0] += 1
        per_name[e.name][1] += t_end - t_start
    kernels = sorted(per_name.items(), key=lambda kv: -kv[1][1])
    rec = {"what": what, **meta, f"{unit}s": units, "sessions": attempt,
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
    return {"flash_attention": flash_attention.launches,
            "flash_tc": flash_attention.tc_launches,
            "flash_wg": flash_attention.wg_launches,
            "rmsnorm": rmsnorm.launches, "rmsnorm_vec": rmsnorm.vec_launches,
            "ssd": ssd.launches, "ssd_tc": ssd.tc_launches,
            "grouped_gemm": grouped_gemm.launches,
            "gemm_tc": grouped_gemm.tc_launches}


def _set_counts() -> None:
    flash_attention.launches = flash_attention.tc_launches = 0
    flash_attention.wg_launches = 0
    rmsnorm.launches = rmsnorm.vec_launches = 0
    ssd.launches = ssd.tc_launches = 0
    grouped_gemm.launches = grouped_gemm.tc_launches = 0


def _pass_counts(norms: int, scans: int, flash: int = 0,
                 gemms: int = 0, flash_wg: int = None) -> dict:
    """The counts of a pass of ``norms`` RMSNorm, ``scans`` SSD, ``flash``
    flash and ``gemms`` grouped GEMM launches, every norm vectorised and
    every scan, flash and GEMM on the tensor cores, ``flash_wg`` of the
    flash launches (by default all: the LM layers' heads of 64 and 128 at
    their prompts) in the Hopper streaming form."""
    return {"flash_attention": flash, "flash_tc": flash,
            "flash_wg": flash if flash_wg is None else flash_wg,
            "rmsnorm": norms,
            "rmsnorm_vec": norms, "ssd": scans, "ssd_tc": scans,
            "grouped_gemm": gemms, "gemm_tc": gemms}


def _lm_inputs(gen, B, S, cfg=LM):
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device="cuda")
    return toks, torch.arange(S, device="cuda").expand(B, S)


def _serve_warm_up(cfg, params, toks, pos, warm: int = 256) -> None:
    """A prefill of the prompts' first ``warm`` tokens and one decode step,
    untimed and uncounted: cuBLAS handles and the libraries load here.
    ``pos`` (B, S), or M-RoPE's (3, B, S)."""
    with torch.inference_mode():
        lg, cache = make_prefill_step(cfg, s_cache=warm + 1)(
            params, toks[:, :warm], pos[..., :warm])
        make_serve_step(cfg)(params, lg.argmax(-1, keepdim=True).to(
            torch.int32), pos[..., :1] + warm, cache, warm)
    torch.cuda.synchronize()


def lm_prefill_decode(cfg, params, toks, pos, per_prefill: dict,
                      per_step: dict, s_cache=None, vision=None,
                      prefill_logits=None) -> dict:
    """One prefill of ``toks`` at ``pos`` ((B, S), or M-RoPE's (3, B, S))
    into a cache of ``s_cache`` positions (the prompt's length by default),
    with ``vision`` (``vision_embeds`` and ``vision_mask``) merged where
    given, and LM_DECODE greedy decode steps from it, each at the positions
    after the prompt's last, with the launch counts checked per prefill and
    per step. The prefill's last-token logits are appended to
    ``prefill_logits`` where it is given."""
    prefill_step = make_prefill_step(cfg, s_cache=s_cache)
    serve_step = make_serve_step(cfg)
    B, S = toks.shape
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = prefill_step(params, toks, pos, **(vision or {}))
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        if _counts() != per_prefill:
            raise RuntimeError(f"prefill launched {_counts()}")
        if logits.shape != (B, cfg.vocab) or not torch.isfinite(logits).all():
            raise RuntimeError(f"bad prefill logits {tuple(logits.shape)}")
        if prefill_logits is not None:
            prefill_logits.append(logits)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
        step_ms = []
        for i in range(LM_DECODE):
            before = _counts()
            t0 = time.perf_counter()
            tok, logits, cache = serve_step(params, tok,
                                            pos[..., -1:] + 1 + i, cache,
                                            S + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            after = _counts()
            if {k: after[k] - before[k] for k in after} != per_step:
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
            "cache_shapes": {k: list(v.shape) for k, v in
                             cache["segments"][0]["b0"].items()}}


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
    res = lm_prefill_decode(LM, params, toks, pos,
                            _pass_counts(NORMS_PER_PASS, LM.n_layers),
                            _pass_counts(NORMS_PER_PASS, 0))
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


# ------------------------------------------- 4c. TinyLlama-1.1B serving
def check_dense_plain(params, toks, full=DENSE, tag="dense_plain",
                      norms=2 * LM_PLAIN_LAYERS + 1, image=None) -> None:
    """The first LM_PLAIN_LAYERS layers of the full-width dense model
    ``full`` (TinyLlama; Qwen1.5-4B; Command-R, whose LayerNorms launch no
    kernel: ``norms`` RMSNorm launches; Qwen2-VL with ``image``, which
    gives a 1 x LM_PLAIN_PROMPT prompt's M-RoPE positions and its vision
    inputs on the card), same weights, prefill of one
    LM_PLAIN_PROMPT-token prompt: kernel path on the card against the plain
    path on the CPU, last-token logits and the KV cache."""
    cfg = full.replace(n_layers=LM_PLAIN_LAYERS)
    sub = dict(params, segments=[{"b0": tree_map(
        lambda t: t[:LM_PLAIN_LAYERS], params["segments"][0]["b0"])}])
    x = toks[:1, :LM_PLAIN_PROMPT]
    pos = torch.arange(LM_PLAIN_PROMPT, device="cuda")[None]
    vision = {}
    if image is not None:
        pos, vision = image(1, LM_PLAIN_PROMPT)
    with torch.inference_mode():
        _set_counts()
        lg, cache = transformer.prefill(sub, cfg, x, pos, **vision)
        torch.cuda.synchronize()
        if _counts() != _pass_counts(norms, 0, LM_PLAIN_LAYERS):
            raise RuntimeError(f"2-layer prefill launched {_counts()}")
        t0 = time.perf_counter()
        lg_cpu, cache_cpu = transformer.prefill(
            tree_map(lambda t: t.cpu(), sub), cfg, x.cpu(), pos.cpu(),
            **{k: v.cpu() for k, v in vision.items()})
        cpu_s = time.perf_counter() - t0
    kv, kv_cpu = (c["segments"][0]["b0"] for c in (cache, cache_cpu))
    line(tag, layers=LM_PLAIN_LAYERS, prompt=LM_PLAIN_PROMPT,
         image_tokens=int(vision["vision_mask"].sum()) if vision else 0,
         logits_max_abs_err=_rel_err(lg, lg_cpu, "logits"),
         logits_scale=lg_cpu.abs().max().item(),
         k_max_abs_err=_rel_err(kv["k"], kv_cpu["k"], "K cache"),
         k_scale=kv_cpu["k"].abs().max().item(),
         v_max_abs_err=_rel_err(kv["v"], kv_cpu["v"], "V cache"),
         v_scale=kv_cpu["v"].abs().max().item(), rel_tol=LM_REL_TOL,
         cpu_plain_s=cpu_s)


def phase_dense() -> dict:
    """TinyLlama-1.1B at its full published width and depth, seeded
    weights drawn on the card: a 4 x 2048 prefill into a cache of 2048 +
    32 positions and 32 greedy decode steps (flash 22 a prefill on the
    tensor cores, none a step; RMSNorm 45 each), the 2-layer check against
    the CPU, a profiled prefill and decode, then the serve launcher at its
    defaults. Returns the prefill's and decode steps' launches."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = transformer.init(gen, DENSE)
    torch.cuda.synchronize()
    leaves = _leaves(params)
    line("dense_init", arch=DENSE.arch_id, layers=DENSE.n_layers,
         d_model=DENSE.d_model, heads=DENSE.nq, kv_heads=DENSE.nkv,
         head_dim=DENSE.hd, d_ff=DENSE.d_ff, vocab=DENSE.vocab,
         params=sum(t.numel() for t in leaves),
         param_gb=sum(t.numel() * t.element_size() for t in leaves) / 1e9,
         seconds=time.perf_counter() - t0)
    toks, pos = _lm_inputs(gen, LM_BATCH, LM_PROMPT, DENSE)
    s_cache = LM_PROMPT + LM_DECODE
    _serve_warm_up(DENSE, params, toks, pos)

    _set_counts()                     # TinyLlama's main path
    res = lm_prefill_decode(DENSE, params, toks, pos,
                            _pass_counts(DENSE_NORMS, 0, DENSE.n_layers),
                            _pass_counts(DENSE_NORMS, 0), s_cache=s_cache)
    launches = _counts()
    line("dense_serve", batch=LM_BATCH, prompt=LM_PROMPT, s_cache=s_cache,
         decode_steps=LM_DECODE, launches=launches,
         flash_per_prefill=DENSE.n_layers, rmsnorm_per_pass=DENSE_NORMS,
         **res)

    check_dense_plain(params, toks)

    # one prefill, then 5 decode steps from its cache, each profiled alone
    prefill_step = make_prefill_step(DENSE, s_cache=s_cache)
    serve_step = make_serve_step(DENSE)
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
        profile_device("tinyllama prefill",
                       lambda: prefill_step(params, toks, pos), 1, "prefill",
                       batch=LM_BATCH, prompt=LM_PROMPT)
    profile_device("tinyllama decode", lambda: decode(PROFILE_STEPS),
                   PROFILE_STEPS, "step", batch=LM_BATCH)
    del params, cache, lg
    torch.cuda.empty_cache()

    _set_counts()
    out = serve_launcher.main(["--arch", DENSE.arch_id])
    counts = _counts()
    if out["done"] != out["requests"]:
        raise RuntimeError(f"engine finished {out['done']} of "
                           f"{out['requests']} requests")
    n = counts["rmsnorm"] // DENSE_NORMS
    if not n or counts != _pass_counts(n * DENSE_NORMS, 0):
        raise RuntimeError(f"engine launched {counts}")
    line("dense_engine", **out, launches=counts, decode_calls=n)
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------ 4d. Qwen1.5-MoE-A2.7B serving
def _moe_capacity(S: int, cfg=QWEN) -> int:
    """The routed experts' capacity a group of S tokens (``topk_moe``)."""
    return max(1, int(np.ceil(S * cfg.top_k * cfg.capacity_factor
                              / cfg.n_experts)))


def _moe_gemm_shapes(cfg=QWEN):
    """(what, rows an expert, d_in, d_out) of the routed experts' two
    grouped GEMMs at a 4 x 2048 prefill (one capacity group a prompt) and
    at a decode step (one token a row)."""
    d, f = cfg.d_model, cfg.expert_d_ff
    pre = LM_BATCH * _moe_capacity(min(LM_PROMPT, cfg.moe_group_size), cfg)
    dec = LM_BATCH * _moe_capacity(1, cfg)
    return [("prefill wi", pre, d, 2 * f), ("prefill wo", pre, f, d),
            ("decode wi", dec, d, 2 * f), ("decode wo", dec, f, d)]


def _moe_train_gemms(cfg, batch: int):
    """(what, E, rows an expert, d_in, d_out) of an MoE model's routed
    experts' two grouped GEMMs at a batch x 2048 training batch, one
    capacity group a sequence: Qwen2-MoE's 2 x 2048 gives 342 rows an
    expert at E = 60, DeepSeek-V2's 1 x 2048 gives 96 at E = 160."""
    d, f = cfg.d_model, cfg.expert_d_ff
    E, C = cfg.n_experts, batch * _moe_capacity(LM_PROMPT, cfg)
    return [("wi", E, C, d, 2 * f), ("wo", E, C, f, d)]


# (model, config, batch) of the MoE training runs whose grouped GEMM
# backward phases 2 and 5 check and time
MOE_TRAIN_GEMMS = (("Qwen2-MoE", QWEN, 2), ("DeepSeek-V2", DEEPSEEK, 1))


def _draw_qkv_bias(gen, params) -> None:
    """Nonzero QKV biases, N(0, QKV_BIAS_STD) in place of the init's zeros,
    so that the run adds them."""
    attn = params["segments"][0]["b0"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = _randn(gen, attn[name].shape, attn[name].dtype,
                            QKV_BIAS_STD)


class _RouteLog:
    """While entered, records every ``topk_moe`` router call of the port
    (its probabilities and chosen experts) and counts the (token, k) pairs
    dropped at capacity; ``force`` replays recorded experts instead of the
    top-k, each with its gate renormalised from this run's probabilities."""

    def __init__(self, force=None):
        self.routes, self.force = [], list(force) if force else None
        self.dropped = None

    def __enter__(self):
        self._route, self._slots = moe_mod._route, moe_mod._capacity_slots

        def route(params, x, cfg):
            probs, gates, idx = self._route(params, x, cfg)
            if self.force is not None:
                idx = self.force.pop(0).to(idx.device)
                gates = probs.gather(-1, idx)
                gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                            min=1e-9)
            self.routes.append((probs.detach(), idx))
            return probs, gates, idx

        def slots(idx, E, C):
            out = self._slots(idx, E, C)
            n = (~out[1]).sum()
            self.dropped = n if self.dropped is None else self.dropped + n
            return out
        moe_mod._route, moe_mod._capacity_slots = route, slots
        return self

    def __exit__(self, *exc):
        moe_mod._route, moe_mod._capacity_slots = self._route, self._slots


def _route_flips(card_routes, cpu_routes) -> dict:
    """Tokens whose top-k experts differ between the card's run and the
    CPU's own choice, layer by layer, and the largest gap (the K-th minus
    the (K+1)-th of the CPU's probabilities, relative to the K-th) among
    them; raises where a flipped token's gap exceeds LM_REL_TOL, which is
    not a near-tie of bf16 roundings."""
    flips, worst = [], 0.0
    for (_, idx), (probs, _) in zip(card_routes, cpu_routes):
        K = idx.shape[-1]
        own = torch.topk(probs, K + 1, dim=-1)
        same = (own.indices[..., :K].sort(-1).values
                == idx.cpu().sort(-1).values).all(-1)
        gap = (own.values[..., -2] - own.values[..., -1]) / own.values[..., -2]
        flips.append(int((~same).sum()))
        if flips[-1]:
            worst = max(worst, float(gap[~same].max()))
    if worst > LM_REL_TOL:
        raise RuntimeError(f"a route flipped at a relative gap of {worst}")
    return {"route_flips_by_layer": flips, "max_flip_gap_rel": worst}


def check_moe_plain(params, toks) -> None:
    """The first LM_PLAIN_LAYERS layers of full-width Qwen2-MoE, same
    weights, prefill of one LM_PLAIN_PROMPT-token prompt: kernel path on
    the card against the plain path on the CPU, last-token logits and the
    KV cache. The CPU run takes the card run's experts for every token
    (its own probabilities give the gates): a token whose K-th and
    (K+1)-th router probabilities lie within bf16 roundings may route the
    other way on the CPU, and one other expert moves its hidden state far
    more than the tolerance. Such flips are counted, and each must be a
    near-tie (``_route_flips``)."""
    cfg = QWEN.replace(n_layers=LM_PLAIN_LAYERS)
    sub = dict(params, segments=[{"b0": tree_map(
        lambda t: t[:LM_PLAIN_LAYERS], params["segments"][0]["b0"])}])
    x = toks[:1, :LM_PLAIN_PROMPT]
    pos = torch.arange(LM_PLAIN_PROMPT, device="cuda")[None]
    with torch.inference_mode():
        _set_counts()
        with _RouteLog() as card:
            lg, cache = transformer.prefill(sub, cfg, x, pos)
        torch.cuda.synchronize()
        if _counts() != _pass_counts(2 * LM_PLAIN_LAYERS + 1, 0,
                                     LM_PLAIN_LAYERS, 2 * LM_PLAIN_LAYERS):
            raise RuntimeError(f"2-layer prefill launched {_counts()}")
        t0 = time.perf_counter()
        with _RouteLog(force=[i for _, i in card.routes]) as cpu:
            lg_cpu, cache_cpu = transformer.prefill(
                tree_map(lambda t: t.cpu(), sub), cfg, x.cpu(), pos.cpu())
        cpu_s = time.perf_counter() - t0
    kv, kv_cpu = (c["segments"][0]["b0"] for c in (cache, cache_cpu))
    line("moe_plain", layers=LM_PLAIN_LAYERS, prompt=LM_PLAIN_PROMPT,
         logits_max_abs_err=_rel_err(lg, lg_cpu, "logits"),
         logits_scale=lg_cpu.abs().max().item(),
         k_max_abs_err=_rel_err(kv["k"], kv_cpu["k"], "K cache"),
         k_scale=kv_cpu["k"].abs().max().item(),
         v_max_abs_err=_rel_err(kv["v"], kv_cpu["v"], "V cache"),
         v_scale=kv_cpu["v"].abs().max().item(), rel_tol=LM_REL_TOL,
         dropped_card=int(card.dropped), dropped_cpu=int(cpu.dropped),
         **_route_flips(card.routes, cpu.routes), cpu_plain_s=cpu_s)


_SERVE_GROUPS = (   # device-time groups of a serving profile
    ("grouped_gemm", ("grouped_gemm_tc_kernel", "grouped_gemm_kernel")),
    ("flash", ("flash_fwd",)),
    ("rmsnorm", ("rmsnorm_kernel", "rmsnorm_vec_kernel")),
    ("cublas", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("routing", ("topk", "TopK", "softmax", "scan", "sort", "radix")),
    ("copy_cast", ("copy",)),
    ("index", ("index", "gather", "scatter")),
)


def _serve_groups(rec: dict, unit: str, groups=_SERVE_GROUPS,
                  rest: str = "other") -> dict:
    """Device ms a ``unit`` of each group of ``groups`` in a profile
    record, the rest as ``rest``."""
    out = defaultdict(float)
    for k in rec["kernels"]:
        group = next((g for g, keys in groups
                      if any(key in k["name"] for key in keys)), rest)
        out[group] += k[f"ms_per_{unit}"]
    return dict(out)


def _moe_drops(prefill_step, params, toks, pos, bias_std: float):
    """One prefill; prints the routed (token, k) pairs it dropped at
    capacity over all layers, with the QKV biases' draw. Returns the
    prefill's (logits, cache)."""
    with torch.inference_mode(), _RouteLog() as log:
        out = prefill_step(params, toks, pos)
    pairs = QWEN.n_layers * LM_BATCH * LM_PROMPT * QWEN.top_k
    line("moe_drops", what="routed (token, k) pairs dropped at capacity, "
         "one 4 x 2048 prefill, all layers", qkv_bias_std=bias_std,
         dropped=int(log.dropped), pairs=pairs,
         share=int(log.dropped) / pairs,
         tokens_in_a_group=min(LM_PROMPT, QWEN.moe_group_size),
         capacity=_moe_capacity(LM_PROMPT))
    return out


def phase_moe() -> dict:
    """Qwen1.5-MoE-A2.7B at its full published width and depth, seeded
    weights drawn on the card with nonzero QKV biases: a 4 x 2048 prefill
    into a cache of 2048 + 32 positions and 32 greedy decode steps (the
    routed experts' 2 grouped GEMMs a layer on the tensor cores, flash 24 a
    prefill on the tensor cores and none a step, RMSNorm 49 each), the
    tokens the prefill drops at capacity, the 2-layer check against the
    CPU, a profiled prefill and decode step by kernel group, the drops
    again with the QKV biases at the init's zeros, then the serve launcher
    at its defaults. Returns the prefill's and decode steps'
    launches."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init(gen, QWEN)
    _draw_qkv_bias(gen, params)
    torch.cuda.synchronize()
    sizes = [(t.numel(), t.element_size()) for t in _leaves(params)]
    line("moe_init", arch=QWEN.arch_id, layers=QWEN.n_layers,
         d_model=QWEN.d_model, heads=QWEN.nq, kv_heads=QWEN.nkv,
         head_dim=QWEN.hd, experts=QWEN.n_experts, top_k=QWEN.top_k,
         shared_experts=QWEN.n_shared_experts, expert_d_ff=QWEN.expert_d_ff,
         vocab=QWEN.vocab, params=sum(n for n, _ in sizes),
         param_gb=sum(n * b for n, b in sizes) / 1e9,
         init_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         qkv_bias_std=QKV_BIAS_STD, seconds=time.perf_counter() - t0)
    toks, pos = _lm_inputs(gen, LM_BATCH, LM_PROMPT, QWEN)
    s_cache = LM_PROMPT + LM_DECODE
    _serve_warm_up(QWEN, params, toks, pos)
    torch.cuda.reset_peak_memory_stats()

    _set_counts()                     # Qwen2-MoE's main path
    res = lm_prefill_decode(
        QWEN, params, toks, pos,
        _pass_counts(QWEN_NORMS, 0, QWEN.n_layers, QWEN_GEMMS),
        _pass_counts(QWEN_NORMS, 0, 0, QWEN_GEMMS), s_cache=s_cache)
    launches = _counts()
    line("moe_serve", batch=LM_BATCH, prompt=LM_PROMPT, s_cache=s_cache,
         decode_steps=LM_DECODE, launches=launches,
         gemm_per_pass=QWEN_GEMMS, flash_per_prefill=QWEN.n_layers,
         rmsnorm_per_pass=QWEN_NORMS,
         capacity_prefill=_moe_capacity(LM_PROMPT),
         capacity_decode=_moe_capacity(1),
         peak_gb=torch.cuda.max_memory_allocated() / 1e9, **res)

    prefill_step = make_prefill_step(QWEN, s_cache=s_cache)
    serve_step = make_serve_step(QWEN)
    lg, cache = _moe_drops(prefill_step, params, toks, pos, QKV_BIAS_STD)

    check_moe_plain(params, toks)

    # the prefill and one decode step, each profiled alone
    tok0 = lg.argmax(-1, keepdim=True).to(torch.int32)

    def decode():
        with torch.inference_mode():
            serve_step(params, tok0, pos[:, -1:] + 1, cache, LM_PROMPT)
    with torch.inference_mode():
        rec = profile_device("qwen2-moe prefill",
                             lambda: prefill_step(params, toks, pos), 1,
                             "prefill", batch=LM_BATCH, prompt=LM_PROMPT)
    line("moe_profile", what="prefill", wall_ms=rec["wall_ms_per_prefill"],
         device_ms=rec["device_ms_per_prefill"],
         device_busy_share=rec["device_busy_share"],
         launches=rec["device_calls_per_prefill"],
         device_ms_by_group=_serve_groups(rec, "prefill"))
    rec = profile_device("qwen2-moe decode", decode, 1, "step",
                         batch=LM_BATCH)
    line("moe_profile", what="decode step", wall_ms=rec["wall_ms_per_step"],
         device_ms=rec["device_ms_per_step"],
         device_busy_share=rec["device_busy_share"],
         launches=rec["device_calls_per_step"],
         device_ms_by_group=_serve_groups(rec, "step"))
    del cache, lg, tok0
    # the drop share again with the QKV biases at the init's zeros
    attn = params["segments"][0]["b0"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name].zero_()
    _moe_drops(prefill_step, params, toks, pos, 0.0)
    del params
    torch.cuda.empty_cache()

    _set_counts()
    out = serve_launcher.main(["--arch", QWEN.arch_id])
    counts = _counts()
    if out["done"] != out["requests"]:
        raise RuntimeError(f"engine finished {out['done']} of "
                           f"{out['requests']} requests")
    n = counts["rmsnorm"] // QWEN_NORMS
    if not n or counts != _pass_counts(n * QWEN_NORMS, 0, 0, n * QWEN_GEMMS):
        raise RuntimeError(f"engine launched {counts}")
    line("moe_engine", **out, launches=counts, decode_calls=n)
    torch.cuda.empty_cache()
    return launches


def profile_serving(tag: str, cfg, params, toks, pos, s_cache: int,
                    groups=_SERVE_GROUPS, rest: str = "other") -> None:
    """One prefill, then PROFILE_STEPS decode steps from its cache, each
    profiled alone; prints a ``[tag]`` line for each, its device time by
    kernel group."""
    prefill_step = make_prefill_step(cfg, s_cache=s_cache)
    serve_step = make_serve_step(cfg)
    with torch.inference_mode():
        lg, cache = prefill_step(params, toks, pos)
    tok0 = lg.argmax(-1, keepdim=True).to(torch.int32)
    S = toks.shape[1]

    def decode(n):
        with torch.inference_mode():
            tok, c = tok0, cache
            for i in range(n):
                tok, _, c = serve_step(params, tok, pos[..., -1:] + 1 + i, c,
                                       S + i)
    with torch.inference_mode():
        rec = profile_device(f"{cfg.arch_id} prefill",
                             lambda: prefill_step(params, toks, pos), 1,
                             "prefill", batch=toks.shape[0], prompt=S)
    line(tag, what="prefill", wall_ms=rec["wall_ms_per_prefill"],
         device_ms=rec["device_ms_per_prefill"],
         device_busy_share=rec["device_busy_share"],
         launches=rec["device_calls_per_prefill"],
         device_ms_by_group=_serve_groups(rec, "prefill", groups, rest))
    rec = profile_device(f"{cfg.arch_id} decode",
                         lambda: decode(PROFILE_STEPS), PROFILE_STEPS,
                         "step", batch=toks.shape[0])
    line(tag, what="decode step", wall_ms=rec["wall_ms_per_step"],
         device_ms=rec["device_ms_per_step"],
         device_busy_share=rec["device_busy_share"],
         launches=rec["device_calls_per_step"],
         device_ms_by_group=_serve_groups(rec, "step", groups, rest))
    del cache, lg, tok0
    torch.cuda.empty_cache()


class _AdmissionCounter(ServeEngine):
    """``ServeEngine`` counting the requests it admits to slots."""

    admitted = 0

    def _admit(self):
        slots = super()._admit()
        self.admitted += len(slots)
        return slots


def engine_at_defaults(tag: str, cfg, params, per_call: dict) -> None:
    """``ServeEngine`` at the serve launcher's defaults (batch 4, s_max
    128, 8 requests of 6-token prompts, 16 new tokens each) on ``params``
    (the launcher itself would draw the model's full depth): raises unless
    every request finished and the run launched a whole number of decode
    calls' ``per_call`` counts; prints a ``[tag]`` line with the slots
    refilled (admissions past the first 4), each cleared first."""
    _set_counts()
    eng = _AdmissionCounter(cfg, params, batch=4, s_max=128)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
        0, cfg.vocab_size, 6)], max_new=16) for i in range(8)]
    for r in reqs:
        eng.add_request(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counts()
    tokens = sum(len(r.out) for r in reqs)
    if len(done) != len(reqs) or not all(r.done for r in reqs):
        raise RuntimeError(f"engine finished {len(done)} of {len(reqs)} "
                           "requests")
    n = counts["rmsnorm"] // per_call["rmsnorm"]
    if not n or counts != {k: n * v for k, v in per_call.items()}:
        raise RuntimeError(f"engine launched {counts}")
    line(tag, batch=4, s_max=128, requests=len(reqs), done=len(done),
         refilled_slots=eng.admitted - 4, tokens=tokens, seconds=dt,
         tokens_per_s=tokens / dt, launches=counts, decode_calls=n)


# ---------------------------------------------- 4e. Gemma-3-27B serving
_GEMMA_GROUPS = (   # device-time groups of a Gemma-3 serving profile
    ("flash", ("flash_fwd",)),
    ("rmsnorm", ("rmsnorm_kernel", "rmsnorm_vec_kernel")),
    ("cublas", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("casts", ("copy",)),
)


def _draw_gemma_norms(gen, params) -> None:
    """Every norm scale (the blocks' four, QK-norm's two, the final one)
    drawn N(0, GEMMA_NORM_STD) in place of the init's zeros, so that
    (1 + w) differs from 1 and a swapped or missing norm shows."""
    for path, t in _items(params):
        if path.endswith("/scale"):
            t.copy_(_randn(gen, t.shape, t.dtype, GEMMA_NORM_STD))


class _WindowLog:
    """While entered, records the window of every call the attention
    module makes to the flash wrapper (the wrapper still launches; this
    counts nothing of the kernel's)."""

    def __enter__(self):
        self.windows = Counter()
        self._flash = attn_mod.flash_attention

        def flash(q, k, v, **kw):
            self.windows[kw.get("window", 0)] += 1
            return self._flash(q, k, v, **kw)
        attn_mod.flash_attention = flash
        return self

    def __exit__(self, *exc):
        attn_mod.flash_attention = self._flash


def check_gemma_plain(params, toks) -> None:
    """Gemma-3's first local and first global layer at full width, same
    weights (segment 0's ``b0`` and ``b5``, as a plan of one (local,
    global) segment): a GEMMA_PLAIN_PROMPT-token prefill, past the window,
    and GEMMA_PLAIN_DECODE decode steps of the prompt's next tokens, on
    the card against the plain path on the CPU: every call's logits and
    both layers' K/V caches at the end (the local one a rolled ring)."""
    cfg = GEMMA.replace(n_layers=2, local_global_period=2)
    seg = params["segments"][0]
    sub = dict(params, segments=[{
        "b0": tree_map(lambda t: t[:1], seg["b0"]),
        "b1": tree_map(lambda t: t[:1], seg["b5"])}])
    P, n = GEMMA_PLAIN_PROMPT, GEMMA_PLAIN_DECODE
    x = toks[:1, :P + n]
    pos = torch.arange(P + n, device="cuda")[None]

    def run(p, x, pos):
        lg, cache = transformer.prefill(p, cfg, x[:, :P], pos[:, :P], P + n)
        lgs = [lg]
        for i in range(P, P + n):
            lg, cache = transformer.decode_step(p, cfg, x[:, i:i + 1],
                                                pos[:, i:i + 1], cache, i)
            lgs.append(lg)
        return lgs, cache["segments"][0]
    with torch.inference_mode():
        _set_counts()
        with _WindowLog() as log:
            lgs, kv = run(sub, x, pos)
        torch.cuda.synchronize()
        norms = (1 + n) * (6 * 2 + 1)
        if _counts() != _pass_counts(norms, 0, 2) or \
                log.windows != Counter({GEMMA.sliding_window: 1, 0: 1}):
            raise RuntimeError(f"2-layer run launched {_counts()}, flash "
                               f"windows {dict(log.windows)}")
        t0 = time.perf_counter()
        lgs_cpu, kv_cpu = run(tree_map(lambda t: t.cpu(), sub), x.cpu(),
                              pos.cpu())
        cpu_s = time.perf_counter() - t0
    errs = {}
    for name, blk in (("local", "b0"), ("global", "b1")):
        for t in ("k", "v"):
            errs[f"{name}_{t}_max_abs_err"] = _rel_err(
                kv[blk][t], kv_cpu[blk][t], f"{name} {t.upper()} cache")
            errs[f"{name}_{t}_scale"] = kv_cpu[blk][t].abs().max().item()
    line("gemma_plain", layers=["local", "global"], prompt=P,
         decode_steps=n, window=GEMMA.sliding_window,
         cache_slots={"local": kv["b0"]["k"].shape[2],
                      "global": kv["b1"]["k"].shape[2]},
         logits_max_abs_err=[_rel_err(a, b, f"logits {i}") for i, (a, b)
                             in enumerate(zip(lgs, lgs_cpu))],
         logits_scale=max(b.abs().max().item() for b in lgs_cpu),
         **errs, rel_tol=LM_REL_TOL, cpu_plain_s=cpu_s)


def phase_gemma() -> dict:
    """Gemma-3-27B at its full published width and 26 of its 62 layers
    (4 x (5 local + 1 global) + 2 local), seeded fp32 weights drawn on the
    card with the norm scales drawn nonzero: a 4 x 2048 prefill into a
    cache of 2048 + 32 positions (the local layers' rings hold 1024) and 32
    greedy decode steps, which wrap every local ring (flash 26 a prefill
    on the tensor cores, 22 of them with the window, none a step; RMSNorm
    157 each, vectorised), the first local and global layer against the
    CPU, a profiled prefill and decode by kernel group, then
    ``ServeEngine`` at the serve launcher's defaults on the same weights.
    Returns the prefill's and decode steps' launches."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init(gen, GEMMA)
    _draw_gemma_norms(gen, params)
    torch.cuda.synchronize()
    sizes = [(t.numel(), t.element_size()) for t in _leaves(params)]
    line("gemma_init", arch=GEMMA.arch_id, layers=GEMMA.n_layers,
         published_layers=gemma3_27b.CONFIG.n_layers,
         plan=[[seg.n_repeat, list(seg.pattern)]
               for seg in layer_plan(GEMMA)],
         d_model=GEMMA.d_model, heads=GEMMA.nq, kv_heads=GEMMA.nkv,
         head_dim=GEMMA.hd, d_ff=GEMMA.d_ff, vocab=GEMMA.vocab,
         window=GEMMA.sliding_window, params=sum(n for n, _ in sizes),
         param_gb=sum(n * b for n, b in sizes) / 1e9,
         init_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         norm_scale_std=GEMMA_NORM_STD, seconds=time.perf_counter() - t0)
    toks, pos = _lm_inputs(gen, LM_BATCH, LM_PROMPT, GEMMA)
    s_cache = LM_PROMPT + LM_DECODE
    _serve_warm_up(GEMMA, params, toks, pos)
    torch.cuda.reset_peak_memory_stats()

    _set_counts()                     # Gemma-3's main path
    with _WindowLog() as log:
        res = lm_prefill_decode(GEMMA, params, toks, pos,
                                _pass_counts(GEMMA_NORMS, 0, GEMMA.n_layers),
                                _pass_counts(GEMMA_NORMS, 0), s_cache=s_cache)
    launches = _counts()
    want = Counter({GEMMA.sliding_window: GEMMA_LOCAL,
                    0: GEMMA.n_layers - GEMMA_LOCAL})
    if log.windows != want:
        raise RuntimeError(f"flash windows {dict(log.windows)}, not {want}")
    line("gemma_serve", batch=LM_BATCH, prompt=LM_PROMPT, s_cache=s_cache,
         decode_steps=LM_DECODE, launches=launches,
         flash_per_prefill=GEMMA.n_layers,
         flash_windows={str(k): v for k, v in log.windows.items()},
         rmsnorm_per_pass=GEMMA_NORMS,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9, **res)

    check_gemma_plain(params, toks)
    profile_serving("gemma_profile", GEMMA, params, toks, pos, s_cache,
                    _GEMMA_GROUPS, "other_elementwise")
    engine_at_defaults("gemma_engine", GEMMA, params,
                       _pass_counts(GEMMA_NORMS, 0))
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------- 4f. DeepSeek-V2-236B serving
def _draw_unit_norms(gen, params, std: float) -> None:
    """Every norm scale drawn N(1, std) in place of the init's ones, so
    that a swapped or missing norm shows."""
    for path, t in _items(params):
        if path.endswith("/scale"):
            t.copy_(1.0 + _randn(gen, t.shape, t.dtype, std))


def _draw_deepseek_norms(gen, params) -> None:
    """Every norm scale (ln1, ln2, MLA's q_norm and kv_norm, the final one)
    drawn N(1, DEEPSEEK_NORM_STD) in place of the init's ones."""
    _draw_unit_norms(gen, params, DEEPSEEK_NORM_STD)


def _near_ties(routes) -> int:
    """Tokens whose K-th and (K+1)-th router probabilities lie within
    NEAR_TIE, over the recorded router calls."""
    n = 0
    for probs, idx in routes:
        top = torch.topk(probs, idx.shape[-1] + 1, dim=-1).values
        n += int(((top[..., -2] - top[..., -1]) < NEAR_TIE).sum())
    return n


def check_deepseek_plain(params, toks) -> None:
    """DeepSeek-V2's dense first layer and first MoE layer at full width,
    same weights (segment 0's layer and segment 1's first, as a 2-layer
    model): a DEEPSEEK_PLAIN_PROMPT-token prefill and
    DEEPSEEK_PLAIN_DECODE decode steps of the prompt's next tokens, on the
    card against the plain path on the CPU (the host holds the MoE layer's
    15.9 GB of fp32 weights): every call's logits and both layers' latent
    caches at the end. The CPU run takes the card run's experts for every token (its own
    probabilities give the gates); tokens its own router would send
    elsewhere are counted, and each must be a near-tie (``_route_flips``)."""
    cfg = DEEPSEEK.replace(n_layers=2)
    segs = params["segments"]
    sub = dict(params, segments=[segs[0], {"b0": tree_map(
        lambda t: t[:1], segs[1]["b0"])}])
    P, n = DEEPSEEK_PLAIN_PROMPT, DEEPSEEK_PLAIN_DECODE
    x = toks[:1, :P + n]
    pos = torch.arange(P + n, device="cuda")[None]

    def run(p, x, pos):
        lg, cache = transformer.prefill(p, cfg, x[:, :P], pos[:, :P], P + n)
        lgs = [lg]
        for i in range(P, P + n):
            lg, cache = transformer.decode_step(p, cfg, x[:, i:i + 1],
                                                pos[:, i:i + 1], cache, i)
            lgs.append(lg)
        return lgs, [seg["b0"] for seg in cache["segments"]]
    with torch.inference_mode():
        _set_counts()
        with _RouteLog() as card:
            lgs, kv = run(sub, x, pos)
        torch.cuda.synchronize()
        if _counts() != _pass_counts((1 + n) * (4 * 2 + 1), 0, 0,
                                     (1 + n) * 2):
            raise RuntimeError(f"2-layer run launched {_counts()}")
        t0 = time.perf_counter()
        host = tree_map(lambda t: t.cpu(), sub)
        copy_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with _RouteLog(force=[i for _, i in card.routes]) as cpu:
            lgs_cpu, kv_cpu = run(host, x.cpu(), pos.cpu())
        cpu_s = time.perf_counter() - t0
        del host
    errs = {}
    for name, a, b in (("dense", kv[0], kv_cpu[0]), ("moe", kv[1], kv_cpu[1])):
        for t in ("ckv", "kr"):
            errs[f"{name}_{t}_max_abs_err"] = _rel_err(
                a[t], b[t], f"{name} {t} cache")
            errs[f"{name}_{t}_scale"] = b[t].abs().max().item()
    line("deepseek_plain", layers=["dense", "moe"], prompt=P,
         decode_steps=n, plain_on="cpu",
         logits_max_abs_err=[_rel_err(a, b, f"logits {i}") for i, (a, b)
                             in enumerate(zip(lgs, lgs_cpu))],
         logits_scale=max(b.abs().max().item() for b in lgs_cpu),
         **errs, rel_tol=LM_REL_TOL, dropped_card=int(card.dropped),
         dropped_cpu=int(cpu.dropped), near_ties_card=_near_ties(card.routes),
         **_route_flips(card.routes, cpu.routes), host_copy_s=copy_s,
         cpu_plain_s=cpu_s)


def check_mla_absorbed(params, gen) -> None:
    """At full width (128 heads, kv rank 512), the dense layer's MLA: the
    absorbed decode of a DEEPSEEK_PLAIN_PROMPT-token input's last position,
    from the latent cache of the positions before it, against
    ``mla_forward``'s expanded output for that position (one function
    computed two ways; bf16 compute, LM_REL_TOL of its scale)."""
    attn = tree_map(lambda t: t[0], params["segments"][0]["b0"]["attn"])
    P = DEEPSEEK_PLAIN_PROMPT
    x = _randn(gen, (1, P, DEEPSEEK.d_model), torch.bfloat16)
    pos = torch.arange(P, device="cuda")[None]
    with torch.inference_mode():
        full = attn_mod.mla_forward(attn, x, DEEPSEEK, pos)[:, -1]
        cache = attn_mod.init_mla_cache(DEEPSEEK, 1, P, device="cuda")
        _, cache = attn_mod.mla_prefill(attn, x[:, :-1], DEEPSEEK,
                                        pos[:, :-1], cache)
        y, _ = attn_mod.mla_decode(attn, x[:, -1:], DEEPSEEK, pos[:, -1:],
                                   cache, P - 1)
    line("deepseek_absorbed", what="absorbed decode vs mla_forward, last "
         "position", prompt=P, heads=DEEPSEEK.nq,
         kv_lora_rank=DEEPSEEK.kv_lora_rank,
         max_abs_err=_rel_err(y[:, 0], full, "absorbed decode"),
         scale=full.abs().max().item(), rel_tol=LM_REL_TOL)


def phase_deepseek() -> dict:
    """DeepSeek-V2-236B at its full published width and 4 of its 60
    layers (the dense first layer and 3 MoE layers), seeded fp32 weights
    drawn on the card with the norm scales drawn N(1, 0.3): a 4 x 2048
    prefill into a latent cache of 2048 + 32 positions and 32 greedy decode
    steps (the routed experts' 2 grouped GEMMs a MoE layer on the tensor
    cores, RMSNorm 17 a pass, vectorised, no flash), the drops at the
    prefill and the steps, the first dense and MoE layer against the CPU,
    the absorbed decode against the expanded forward, a profiled prefill
    and decode by kernel group, then ``ServeEngine`` at the serve
    launcher's defaults on the same weights. Returns the prefill's and
    decode steps' launches."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init(gen, DEEPSEEK)
    _draw_deepseek_norms(gen, params)
    torch.cuda.synchronize()
    sizes = [(t.numel(), t.element_size()) for t in _leaves(params)]
    line("deepseek_init", arch=DEEPSEEK.arch_id, layers=DEEPSEEK.n_layers,
         published_layers=deepseek_v2_236b.CONFIG.n_layers,
         plan=[[seg.n_repeat, list(seg.pattern)]
               for seg in layer_plan(DEEPSEEK)],
         d_model=DEEPSEEK.d_model, heads=DEEPSEEK.nq,
         q_lora_rank=DEEPSEEK.q_lora_rank,
         kv_lora_rank=DEEPSEEK.kv_lora_rank,
         qk_head_dim=DEEPSEEK.qk_nope_head_dim + DEEPSEEK.qk_rope_head_dim,
         v_head_dim=DEEPSEEK.v_head_dim, experts=DEEPSEEK.n_experts,
         top_k=DEEPSEEK.top_k, shared_experts=DEEPSEEK.n_shared_experts,
         expert_d_ff=DEEPSEEK.expert_d_ff,
         dense_d_ff=DEEPSEEK.shared_d_ff or DEEPSEEK.d_ff,
         vocab=DEEPSEEK.vocab, params=sum(n for n, _ in sizes),
         param_gb=sum(n * b for n, b in sizes) / 1e9,
         init_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         norm_scale_std=DEEPSEEK_NORM_STD, seconds=time.perf_counter() - t0)
    toks, pos = _lm_inputs(gen, LM_BATCH, LM_PROMPT, DEEPSEEK)
    s_cache = LM_PROMPT + LM_DECODE
    _serve_warm_up(DEEPSEEK, params, toks, pos)
    torch.cuda.reset_peak_memory_stats()

    per_pass = _pass_counts(DEEPSEEK_NORMS, 0, 0, DEEPSEEK_GEMMS)
    _set_counts()                     # DeepSeek-V2's main path
    with _RouteLog() as log:
        res = lm_prefill_decode(DEEPSEEK, params, toks, pos, per_pass,
                                per_pass, s_cache=s_cache)
    launches = _counts()
    fallbacks = (launches["grouped_gemm"] - launches["gemm_tc"]
                 + launches["rmsnorm"] - launches["rmsnorm_vec"])
    line("deepseek_serve", batch=LM_BATCH, prompt=LM_PROMPT, s_cache=s_cache,
         decode_steps=LM_DECODE, launches=launches,
         gemm_per_pass=DEEPSEEK_GEMMS, flash_per_prefill=0,
         rmsnorm_per_pass=DEEPSEEK_NORMS, fallbacks=fallbacks,
         capacity_prefill=_moe_capacity(LM_PROMPT, DEEPSEEK),
         capacity_decode=_moe_capacity(1, DEEPSEEK),
         peak_gb=torch.cuda.max_memory_allocated() / 1e9, **res)
    moe_layers = DEEPSEEK.n_layers - DEEPSEEK.first_k_dense
    prefill_calls = log.routes[:moe_layers]
    with torch.inference_mode(), _RouteLog() as pre:
        make_prefill_step(DEEPSEEK, s_cache=s_cache)(params, toks, pos)
    pairs = moe_layers * LM_BATCH * LM_PROMPT * DEEPSEEK.top_k
    line("deepseek_drops", what="routed (token, k) pairs dropped at "
         "capacity, all MoE layers", prefill_dropped=int(pre.dropped),
         prefill_pairs=pairs, prefill_share=int(pre.dropped) / pairs,
         decode_dropped=int(log.dropped) - int(pre.dropped),
         decode_pairs=moe_layers * LM_BATCH * LM_DECODE * DEEPSEEK.top_k,
         near_ties_prefill=_near_ties(prefill_calls),
         near_ties_decode=_near_ties(log.routes[moe_layers:]),
         tokens_routed=moe_layers * LM_BATCH * (LM_PROMPT + LM_DECODE))
    del log, pre, prefill_calls

    check_deepseek_plain(params, toks)
    check_mla_absorbed(params, gen)
    profile_serving("deepseek_profile", DEEPSEEK, params, toks, pos, s_cache)
    engine_at_defaults("deepseek_engine", DEEPSEEK, params, per_pass)
    del params
    torch.cuda.empty_cache()
    return launches


# ----------------------------------------------- 4g. Qwen1.5-4B serving
def phase_qwen4b() -> dict:
    """Qwen1.5-4B at its full published width and depth (40 layers, d 2560,
    20 heads of 128 over as many kv heads, d_ff 6912, vocab 151,936, QKV
    bias), seeded fp32 weights drawn on the card with the QKV biases drawn
    N(0, QKV_BIAS_STD): a 4 x 2048 prefill into a cache of 2048 + 32
    positions and 32 greedy decode steps (flash 40 a prefill on the tensor
    cores, none a step; RMSNorm 81 each, vectorised), the peak memory, and
    the first 2 layers against the CPU. Returns the prefill's and decode
    steps' launches."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init(gen, QWEN4B)
    _draw_qkv_bias(gen, params)
    torch.cuda.synchronize()
    sizes = [(t.numel(), t.element_size()) for t in _leaves(params)]
    line("qwen4b_init", arch=QWEN4B.arch_id, layers=QWEN4B.n_layers,
         d_model=QWEN4B.d_model, heads=QWEN4B.nq, kv_heads=QWEN4B.nkv,
         head_dim=QWEN4B.hd, d_ff=QWEN4B.d_ff, vocab=QWEN4B.vocab,
         rope_theta=QWEN4B.rope_theta, qkv_bias_std=QKV_BIAS_STD,
         params=sum(n for n, _ in sizes),
         param_gb=sum(n * b for n, b in sizes) / 1e9,
         seconds=time.perf_counter() - t0)
    toks, pos = _lm_inputs(gen, LM_BATCH, LM_PROMPT, QWEN4B)
    s_cache = LM_PROMPT + LM_DECODE
    _serve_warm_up(QWEN4B, params, toks, pos)
    torch.cuda.reset_peak_memory_stats()

    _set_counts()                     # Qwen1.5-4B's main path
    res = lm_prefill_decode(QWEN4B, params, toks, pos,
                            _pass_counts(QWEN4B_NORMS, 0, QWEN4B.n_layers),
                            _pass_counts(QWEN4B_NORMS, 0), s_cache=s_cache)
    launches = _counts()
    line("qwen4b_serve", batch=LM_BATCH, prompt=LM_PROMPT, s_cache=s_cache,
         decode_steps=LM_DECODE, launches=launches,
         flash_per_prefill=QWEN4B.n_layers, rmsnorm_per_pass=QWEN4B_NORMS,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9, **res)
    check_dense_plain(params, toks, QWEN4B, "qwen4b_plain")
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------- 4h. Zamba2-7B serving
_ZAMBA_GROUPS = (   # device-time groups of a Zamba2 serving profile
    ("flash", ("flash_fwd",)),
    ("ssd", ("ssd_kernel", "ssd_tc_kernel")),
    ("rmsnorm", ("rmsnorm_kernel", "rmsnorm_vec_kernel")),
    ("cublas", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("softmax", ("softmax",)),
    ("casts", ("copy",)),
)


def _zamba_applications(seg, groups: int):
    """(name, kind, params) of each block application of the first
    ``groups`` groups of Zamba2's first segment ``seg``, in order: a
    stacked position's layer, the tied position's one tree."""
    plan = layer_plan(ZAMBA)[0]
    for r in range(groups):
        for j, (kind, tied) in enumerate(zip(plan.pattern, plan.shared)):
            p = seg[f"b{j}"]
            yield (f"{r}/b{j}", kind,
                   p if tied else tree_map(lambda t, r=r: t[r], p))


def check_zamba_plain(params, toks) -> None:
    """Zamba2's first ZAMBA_PLAIN_GROUPS groups at full width, same weights
    (14 of its layers: 12 Mamba blocks, the shared block applied twice), a
    1 x ZAMBA_PLAIN_PROMPT prompt (a chunk of 256 and a ragged one), on
    the card against the plain path on the CPU. At this depth bf16's own
    rounding moves the logits by more than LM_REL_TOL (the CPU's bf16 path
    against its fp32 one: ``cpu_bf16_vs_fp32``), so the check is made
    three ways: (1) block by block, each card block fed the CPU block's
    input, in bf16 through the main path's kernels: every block's output,
    both applications' K/V, every Mamba block's final SSM state and the
    last-token logits within LM_REL_TOL; (2) the whole prefill in fp32 on
    both sides within FP32_LM_REL_TOL (the tied block's two applications
    and every layer's wiring); (3) the whole bf16 prefill on the card, its
    launches counted, against the CPU's fp32 one: no further off than the
    CPU's own bf16 path plus LM_REL_TOL."""
    n = ZAMBA_PLAIN_GROUPS
    cfg = ZAMBA.replace(n_layers=n * ZAMBA.attn_every)
    cfg32 = cfg.replace(compute_dtype="float32")
    seg = params["segments"][0]
    sub = dict(params, segments=[{
        f"b{j}": seg[f"b{j}"] if tied else tree_map(lambda t: t[:n],
                                                     seg[f"b{j}"])
        for j, tied in enumerate(layer_plan(ZAMBA)[0].shared)}])
    cpu = tree_map(lambda t: t.cpu(), sub)
    mamba = n * (ZAMBA.attn_every - 1)
    P = ZAMBA_PLAIN_PROMPT
    x = toks[:1, :P]
    pos = torch.arange(P, device="cuda")[None]

    def last_logits(tree, h):
        h = apply_norm(tree["final_norm"], h[:, -1:], cfg)
        return lm_logits(tree, h, cfg, embed_params=tree.get("embed"))[:, 0]
    errs = defaultdict(float)
    with torch.inference_mode():
        _set_counts()
        lg, _ = transformer.prefill(sub, cfg, x, pos)
        torch.cuda.synchronize()
        if _counts() != _pass_counts(2 * mamba + 2 * n + 1, mamba, n):
            raise RuntimeError(f"{cfg.n_layers}-layer prefill launched "
                               f"{_counts()}")
        lg32, _ = transformer.prefill(sub, cfg32, x, pos)
        t0 = time.perf_counter()
        lc32, _ = transformer.prefill(cpu, cfg32, x.cpu(), pos.cpu())
        h = transformer.embed_inputs(cpu, cfg, x.cpu())
        for (name, kind, p), (_, _, pc) in zip(
                _zamba_applications(seg, n),
                _zamba_applications(cpu["segments"][0], n)):
            hg, _, cg = apply_block(p, kind, h.cuda(), cfg, pos, "prefill",
                                    init_block_cache(kind, cfg, 1, P,
                                                     device="cuda"))
            h, _, cc = apply_block(pc, kind, h, cfg, pos.cpu(), "prefill",
                                   init_block_cache(kind, cfg, 1, P,
                                                    device="cpu"))
            errs["hidden"] = max(errs["hidden"],
                                 _rel_err(hg, h, f"block {name}"))
            for k in ("k", "v") if kind == "attn" else ("state",):
                errs[k] = max(errs[k], _rel_err(cg[k], cc[k],
                                                f"block {name} {k}"))
        lc = last_logits(cpu, h)
        cpu_s = time.perf_counter() - t0
        errs["logits"] = _rel_err(last_logits(sub, h.cuda()), lc, "logits")
    scale = lc32.abs().max().item()
    card_vs_fp32 = (lg.cpu() - lc32).abs().max().item() / scale
    cpu_vs_fp32 = (lc - lc32).abs().max().item() / scale
    if card_vs_fp32 > cpu_vs_fp32 + LM_REL_TOL:
        raise RuntimeError(f"the card's bf16 logits are {card_vs_fp32} of "
                           f"scale off fp32, the CPU's {cpu_vs_fp32}")
    line("zamba_plain", layers=cfg.n_layers, mamba_blocks=mamba,
         shared_applications=n, prompt=P, rel_tol=LM_REL_TOL,
         block_by_block={f"{k}_max_abs_err": v for k, v in errs.items()},
         logits_scale=lc.abs().max().item(),
         fp32_logits_max_abs_err=_rel_err(lg32, lc32, "fp32 logits",
                                          FP32_LM_REL_TOL),
         fp32_rel_tol=FP32_LM_REL_TOL, card_bf16_vs_fp32=card_vs_fp32,
         cpu_bf16_vs_fp32=cpu_vs_fp32,
         card_vs_cpu_bf16=(lg.cpu() - lc).abs().max().item()
         / lc.abs().max().item(), cpu_plain_s=cpu_s)


def phase_zamba() -> dict:
    """Zamba2-7B at its full published width (d 3584, d_inner 7168, 112
    SSD heads of 64, state 64; the one shared attention + MLP block, 32
    heads of 112 and d_ff 14,336; vocab 32,000) and ZAMBA's 32 of its 81
    layers (28 Mamba blocks, the shared block applied 4 times), seeded
    fp32 weights drawn on the card with every norm scale drawn N(1,
    ZAMBA_NORM_STD): a 4 x 2048 prefill into a cache of 2048 + 32
    positions and 32 greedy decode steps (28 scans a prefill on the tensor
    cores, 4 flash launches in the Hopper form, the shared block's heads
    of 112, and 65 RMSNorm a pass vectorised, the out_norms at 896 vectors
    a row among them; a decode step's attention keeps the reference math),
    the peak memory, 14
    layers against the CPU, a profiled prefill and decode step, and
    ``ServeEngine`` at the launcher's defaults, its slots refilled. Returns
    the prefill's and decode steps' launches."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init(gen, ZAMBA)
    _draw_unit_norms(gen, params, ZAMBA_NORM_STD)
    torch.cuda.synchronize()
    sizes = [(t.numel(), t.element_size()) for t in _leaves(params)]
    n_params = sum(n for n, _ in sizes)
    if n_params != ZAMBA_PARAMS:
        raise RuntimeError(f"Zamba2-7B at {ZAMBA.n_layers} layers has "
                           f"{n_params} parameters, not the reference's "
                           f"{ZAMBA_PARAMS}")
    line("zamba_init", arch=ZAMBA.arch_id, layers=ZAMBA.n_layers,
         published_layers=zamba2_7b.CONFIG.n_layers,
         mamba_blocks=ZAMBA_MAMBA, shared_applications=ZAMBA_ATTN,
         d_model=ZAMBA.d_model, d_inner=ZAMBA.d_inner,
         ssm_heads=ZAMBA.ssm_nheads, ssm_headdim=ZAMBA.ssm_headdim,
         ssm_state=ZAMBA.ssm_state, heads=ZAMBA.nq, head_dim=ZAMBA.hd,
         d_ff=ZAMBA.d_ff, vocab=ZAMBA.vocab, norm_std=ZAMBA_NORM_STD,
         params=n_params, param_gb=sum(n * b for n, b in sizes) / 1e9,
         seconds=time.perf_counter() - t0)
    toks, pos = _lm_inputs(gen, LM_BATCH, LM_PROMPT, ZAMBA)
    s_cache = LM_PROMPT + LM_DECODE
    _serve_warm_up(ZAMBA, params, toks, pos)
    torch.cuda.reset_peak_memory_stats()

    _set_counts()                     # Zamba2-7B's main path
    res = lm_prefill_decode(ZAMBA, params, toks, pos,
                            _pass_counts(ZAMBA_NORMS, ZAMBA_MAMBA, ZAMBA_ATTN),
                            _pass_counts(ZAMBA_NORMS, 0), s_cache=s_cache)
    launches = _counts()
    line("zamba_serve", batch=LM_BATCH, prompt=LM_PROMPT, s_cache=s_cache,
         decode_steps=LM_DECODE, launches=launches,
         ssd_per_prefill=ZAMBA_MAMBA, flash_per_prefill=ZAMBA_ATTN,
         flash_form=fwd_form(LM_PROMPT, LM_PROMPT, ZAMBA.hd),
         rmsnorm_per_pass=ZAMBA_NORMS,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9, **res)
    check_zamba_plain(params, toks)
    profile_serving("zamba_profile", ZAMBA, params, toks, pos, s_cache,
                    _ZAMBA_GROUPS, "other_elementwise")
    engine_at_defaults("zamba_engine", ZAMBA, params,
                       _pass_counts(ZAMBA_NORMS, 0))
    del params
    torch.cuda.empty_cache()
    return launches


# --------------------------------------------- 4i. Command-R 35B serving
def _draw_layer_norms(gen, params, std: float) -> None:
    """Every LayerNorm scale drawn N(1, std) and bias N(0, std) in place
    of the init's ones and zeros."""
    for path, t in _items(params):
        if path.endswith("/scale") or path.endswith("/bias"):
            t.copy_(_randn(gen, t.shape, t.dtype, std)
                    + path.endswith("/scale"))


def phase_cmdr() -> dict:
    """Command-R 35B at its full published width (d 8192, 64 q heads over
    8 kv heads of 128, d_ff 22,528, vocab 256,000, LayerNorm, the parallel
    block, a tied table) and CMDR.n_layers of its 40 layers, seeded fp32
    weights drawn on the card with the LayerNorm parameters drawn: a 4 x
    2048 prefill into a cache of 2048 + 32 positions and 32 greedy decode
    steps (flash one a layer in a prefill, causal GQA on the tensor cores;
    no RMSNorm: LayerNorm is plain PyTorch, as in the reference), the peak
    memory, the first 2 layers against the CPU, and a profiled prefill and
    decode step. Returns the prefill's and decode steps' launches."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init(gen, CMDR)
    _draw_layer_norms(gen, params, CMDR_NORM_STD)
    torch.cuda.synchronize()
    sizes = [(t.numel(), t.element_size()) for t in _leaves(params)]
    n_params = sum(n for n, _ in sizes)
    if n_params != CMDR_PARAMS:
        raise RuntimeError(f"Command-R at {CMDR.n_layers} layers has "
                           f"{n_params} parameters, not {CMDR_PARAMS}")
    line("cmdr_init", arch=CMDR.arch_id, layers=CMDR.n_layers,
         published_layers=command_r_35b.CONFIG.n_layers,
         d_model=CMDR.d_model, heads=CMDR.nq, kv_heads=CMDR.nkv,
         head_dim=CMDR.hd, d_ff=CMDR.d_ff, vocab=CMDR.vocab,
         parallel_block=CMDR.parallel_block, norm_std=CMDR_NORM_STD,
         params=n_params, param_gb=sum(n * b for n, b in sizes) / 1e9,
         init_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         seconds=time.perf_counter() - t0)
    toks, pos = _lm_inputs(gen, LM_BATCH, LM_PROMPT, CMDR)
    s_cache = LM_PROMPT + LM_DECODE
    _serve_warm_up(CMDR, params, toks, pos)
    torch.cuda.reset_peak_memory_stats()

    _set_counts()                     # Command-R's main path
    res = lm_prefill_decode(CMDR, params, toks, pos,
                            _pass_counts(0, 0, CMDR.n_layers),
                            _pass_counts(0, 0), s_cache=s_cache)
    launches = _counts()
    line("cmdr_serve", batch=LM_BATCH, prompt=LM_PROMPT, s_cache=s_cache,
         decode_steps=LM_DECODE, launches=launches,
         flash_per_prefill=CMDR.n_layers,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9, **res)
    check_dense_plain(params, toks, CMDR, "cmdr_plain", norms=0)
    profile_serving("cmdr_profile", CMDR, params, toks, pos, s_cache,
                    _GEMMA_GROUPS, "other_elementwise")
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------- 4j. Qwen2-VL-7B serving
def vl_image(start: int, rows: int, cols: int):
    """A function of (B, S) giving, for B prompts of S tokens each holding
    one image of one frame, a ``rows`` x ``cols`` merged grid at tokens
    ``start``.., Qwen2-VL's (3, B, S) (t, h, w) positions (the text before
    it at 0..start-1 on every stream, the grid at t = start, h = start +
    row, w = start + col, the text after it from start + max(rows, cols)
    on) and its vision inputs: the (B, S) mask and N(0, 1) patch embeddings
    drawn on the card (the vision encoder is a stub, as in the
    reference)."""
    def build(B: int, S: int):
        n = rows * cols
        cell = torch.arange(n, device="cuda")
        pos = torch.arange(S, device="cuda").repeat(3, 1)
        pos[0, start:start + n] = start
        pos[1, start:start + n] = start + cell // cols
        pos[2, start:start + n] = start + cell % cols
        pos[:, start + n:] = start + max(rows, cols) + torch.arange(
            S - start - n, device="cuda")
        mask = torch.zeros(S, dtype=torch.bool, device="cuda")
        mask[start:start + n] = True
        gen = torch.Generator(device="cuda").manual_seed(start + n)
        embeds = torch.randn(B, S, VL.d_model, generator=gen, device="cuda")
        return pos[:, None].expand(3, B, S), {
            "vision_embeds": embeds, "vision_mask": mask.expand(B, S)}
    return build


def phase_vl() -> dict:
    """Qwen2-VL-7B at its full published width and depth (28 layers, d
    3584, 28 q heads over 4 kv heads of 128, d_ff 18,944, vocab 152,064,
    QKV bias, M-RoPE (16, 24, 24) at theta 1e6), seeded fp32 weights drawn
    on the card with the QKV biases drawn N(0, QKV_BIAS_STD): a 4 x 2048
    text prefill into a cache of 2048 + 32 positions and 32 greedy decode
    steps, then the same prompts with a 1,024-token image (a 32 x 32 merged
    grid at tokens 64-1087, Qwen2-VL's (t, h, w) positions, patch
    embeddings drawn on the card) and 32 steps after it (flash 28 a prefill
    on the tensor cores, 28 q heads over 4 kv heads of 128, none a step;
    RMSNorm 57 each, vectorised), the image's logits against the text's
    (they must differ), the peak memory, the first 2 layers with a 64-token
    image against the CPU, a profiled prefill and decode step, and
    ``ServeEngine`` at the launcher's defaults. Returns the prefills' and
    decode steps' launches."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init(gen, VL)
    _draw_qkv_bias(gen, params)
    torch.cuda.synchronize()
    sizes = [(t.numel(), t.element_size()) for t in _leaves(params)]
    n_params = sum(n for n, _ in sizes)
    if n_params != VL_PARAMS:
        raise RuntimeError(f"Qwen2-VL-7B has {n_params} parameters, not "
                           f"the reference's {VL_PARAMS}")
    line("vl_init", arch=VL.arch_id, layers=VL.n_layers, d_model=VL.d_model,
         heads=VL.nq, kv_heads=VL.nkv, head_dim=VL.hd, d_ff=VL.d_ff,
         vocab=VL.vocab, mrope_sections=list(VL.mrope_sections),
         rope_theta=VL.rope_theta, qkv_bias_std=QKV_BIAS_STD,
         params=n_params, param_gb=sum(n * b for n, b in sizes) / 1e9,
         seconds=time.perf_counter() - t0)
    toks, pos = _lm_inputs(gen, LM_BATCH, LM_PROMPT, VL)
    pos = pos.expand(3, LM_BATCH, LM_PROMPT)    # text: the streams equal
    ipos, vision = vl_image(*VL_IMAGE)(LM_BATCH, LM_PROMPT)
    s_cache = LM_PROMPT + LM_DECODE
    _serve_warm_up(VL, params, toks, pos)
    torch.cuda.reset_peak_memory_stats()
    per_step = _pass_counts(VL_NORMS, 0)
    launches, last = Counter(), []
    for what, p, v in (("text", pos, None), ("image", ipos, vision)):
        _set_counts()                 # Qwen2-VL's main path, each prompt
        res = lm_prefill_decode(VL, params, toks, p,
                                _pass_counts(VL_NORMS, 0, VL.n_layers),
                                per_step, s_cache=s_cache, vision=v,
                                prefill_logits=last)
        counts = _counts()
        launches.update(counts)
        line("vl_serve", prompt=what, batch=LM_BATCH, prompt_tokens=LM_PROMPT,
             s_cache=s_cache, decode_steps=LM_DECODE, launches=counts,
             flash_per_prefill=VL.n_layers, rmsnorm_per_pass=VL_NORMS,
             peak_gb=torch.cuda.max_memory_allocated() / 1e9, **res)
    start, rows, cols = VL_IMAGE
    scale = last[0].abs().max().item()
    change = (last[1] - last[0]).abs().max().item() / scale
    if not change > LM_REL_TOL:
        raise RuntimeError(f"the image moved the last-token logits by "
                           f"{change} of their scale")
    n = rows * cols
    line("vl_image", first_token=start, grid=[rows, cols], image_tokens=n,
         positions_at_image={k: [int(ipos[i, 0, start]),
                                 int(ipos[i, 0, start + n - 1])]
                             for i, k in enumerate("thw")},
         last_position=int(ipos[0, 0, -1]),
         logits_rel_change=change, text_logits_scale=scale,
         must_exceed=LM_REL_TOL)
    del last, ipos, vision
    check_dense_plain(params, toks, VL, "vl_plain", image=vl_image(
        *VL_PLAIN_IMAGE))
    profile_serving("vl_profile", VL, params, toks, pos, s_cache,
                    _GEMMA_GROUPS, "other_elementwise")
    engine_at_defaults("vl_engine", VL, params, per_step)
    del params
    torch.cuda.empty_cache()
    return dict(launches)


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


# ------------------------------------------------- 8. LM training
def _set_lm_train_counts() -> None:
    _set_counts()
    rmsnorm.bwd_launches = rmsnorm.bwd_vec_launches = 0
    ssd.bwd_launches = ssd.bwd_tc_launches = 0
    flash_attention_bwd.launches = flash_attention_bwd.tc_launches = 0
    flash_attention_bwd.wg_launches = 0
    grouped_gemm.bwd_launches = grouped_gemm.bwd_tc_launches = 0
    grouped_gemm.bwd_fused_calls = 0


def _lm_train_counts() -> dict:
    return dict(_counts(), rmsnorm_bwd=rmsnorm.bwd_launches,
                rmsnorm_bwd_vec=rmsnorm.bwd_vec_launches,
                ssd_bwd=ssd.bwd_launches, ssd_bwd_tc=ssd.bwd_tc_launches,
                flash_attention_bwd=flash_attention_bwd.launches,
                flash_bwd_tc=flash_attention_bwd.tc_launches,
                flash_bwd_wg=flash_attention_bwd.wg_launches,
                grouped_gemm_bwd=grouped_gemm.bwd_fused_calls,
                grouped_gemm_bwd_products=grouped_gemm.bwd_launches,
                gemm_bwd_tc=grouped_gemm.bwd_tc_launches)


def _train_pass_counts(cfg, passes: int, seq: int = LM_PROMPT) -> dict:
    """The launches of ``passes`` differentiated micro-batch passes of
    ``cfg``, each forward and backward: per layer two RMSNorm (Gemma-3 six:
    its post-norms and QK-norm too; DeepSeek-V2 four: MLA's q_norm and
    kv_norm; Zamba2 two a Mamba block, ln and the gated out_norm, and two an
    application of the shared block) and, for each Mamba block, an SSD
    scan, for each attention layer of a config at ``attn_impl="flash"`` a
    flash call, and for each MoE layer the routed experts' two grouped
    GEMMs (the backward one fused call a projection, dX and dW); plus the
    final norm; none for LayerNorm (HuBERT, Command-R); every norm
    vectorised and every scan, flash and GEMM on the tensor cores, both
    ways. Under ``cfg.remat`` every layer's forward runs again in the
    backward (the recompute), so its forward launches count twice; the
    final norm's, outside the layers, once. Flash at sequences of ``seq``
    takes the Hopper streaming form where ``fwd_form`` and ``bwd_tc_form``
    say so (the LM heads of 64, 80, 112 and 128 past the short forms: every
    run but TinyLlama's forward at 128 tokens, which fits the short
    form)."""
    layers = cfg.n_layers
    runs = _passes(cfg)
    per_layer = 2 + 2 * cfg.sandwich_norm + 2 * cfg.qk_norm + 2 * cfg.use_mla
    rms = cfg.norm_style == "rms"
    norms = passes * (per_layer * layers + 1) if rms else 0
    mamba = sum(seg.n_repeat * seg.pattern.count("mamba")
                for seg in layer_plan(cfg))
    scans = passes * mamba
    flash = passes * (layers - mamba) if cfg.attn_impl == "flash" else 0
    moe_layers = layers - cfg.first_k_dense if cfg.family == "moe" else 0
    gemms = 2 * passes * moe_layers
    fwd_norms = passes * (runs * per_layer * layers + 1) if rms else 0
    wg = bool(flash) and fwd_form(seq, seq, cfg.hd) == "wg"
    bwd_wg = bool(flash) and bwd_tc_form(seq, seq, cfg.nq, cfg.nkv,
                                         cfg.hd) == "wg"
    return dict(_pass_counts(fwd_norms, runs * scans, runs * flash,
                             runs * gemms, runs * flash * wg),
                rmsnorm_bwd=norms,
                rmsnorm_bwd_vec=norms, ssd_bwd=scans, ssd_bwd_tc=scans,
                flash_attention_bwd=flash, flash_bwd_tc=flash,
                flash_bwd_wg=flash * bwd_wg,
                grouped_gemm_bwd=gemms, grouped_gemm_bwd_products=2 * gemms,
                gemm_bwd_tc=2 * gemms)


def _passes(cfg) -> int:
    """Forward runs of a layer in a differentiated pass: 2 under remat."""
    return 2 if cfg.remat else 1


def _check_lm_train_counts(what: str, passes: int, cfg=LM,
                           seq: int = LM_PROMPT) -> dict:
    """The launches since the counts were zeroed must be those of
    ``passes`` differentiated micro-batch passes of ``cfg`` at ``seq``
    tokens a row (``_train_pass_counts``)."""
    got = _lm_train_counts()
    want = _train_pass_counts(cfg, passes, seq)
    if not passes or got != want:
        raise RuntimeError(f"{what}: launched {got}, expected {want}")
    return got


def _train_state(cfg, draw=None) -> list:
    """[params, opt]: seeded fp32 weights of ``cfg`` drawn on the card
    (``draw`` then redraws some of them) and AdamW's zero state, in a list
    that ``lm_train_run`` updates in place, so that no caller holds the
    trees a step replaces: a step's peak is one state and its successor."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = [transformer.init(gen, cfg), None]
    if draw is not None:
        draw(gen, state[0])
    state[1] = init_opt_state(state[0], TRAIN_OCFG)
    return state


def lm_train_run(state, what, batch, seq, steps, microbatches=1, cfg=LM):
    """``steps`` train steps of ``make_train_step`` on ``cfg`` at the
    launcher's optimizer on ``data_iterator`` batches from ``state``
    ([params, opt], updated in place), after one warm-up step whose result
    is dropped; host ms per step after ``synchronize``. Returns the
    launches."""
    step_fn = make_train_step(cfg, TRAIN_OCFG, microbatches)
    data = data_iterator(cfg, DataConfig(batch=batch, seq_len=seq),
                         device="cuda")
    step_fn(*state, next(data))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _set_lm_train_counts()
    ms, losses = [], []
    for _ in range(steps):
        b = next(data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state[0], state[1], metrics = step_fn(*state, b)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    counts = _check_lm_train_counts(what, steps * microbatches, cfg, seq)
    line("lm_train", arch=cfg.arch_id, layers=cfg.n_layers, run=what,
         batch=batch, seq=seq, steps=steps,
         microbatches=microbatches, ms_per_step=_ms(ms),
         tokens_per_s=batch * seq / np.mean(ms) * 1e3,
         losses=_finite(what, losses),
         grad_norm=float(metrics["grad_norm"]), lr=float(metrics["lr"]),
         peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches=counts)
    return counts


def _lm_grad_sub(params, cfg=LM):
    """(config, tree) of the first LM_PLAIN_LAYERS layers of the model,
    same weights (the model itself if it has no more)."""
    if cfg.n_layers <= LM_PLAIN_LAYERS:
        return cfg, params
    cfg = cfg.replace(n_layers=LM_PLAIN_LAYERS)
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
        what = f"gradient {path} {tuple(g.shape)}"
        err, scale = _err_scale(g, pg, what)
        _within(what, err, scale, LM_REL_TOL)
        errs[path] = err / scale if scale else 0.0
    return errs


def _cpu_inputs(sub, batch):
    return (tree_map(lambda t: t.cpu(), sub),
            {k: v.cpu() for k, v in batch.items()})


def check_lm_train_grads(params, full=LM, seq=LM_GRAD_SEQ,
                         image=None, cut=_lm_grad_sub,
                         run="2-layer gradient check") -> None:
    """A sub-model of the full-width model ``full``, same weights (``cut``:
    by default its first 2 layers), one 1 x ``seq`` batch (for Mamba2 two
    chunks; for Qwen2-VL with ``image``'s M-RoPE positions and vision
    inputs): ``loss_fn``'s gradient with the kernels on the card, its
    launches checked, against the plain path on the CPU, every leaf within
    LM_REL_TOL of its largest magnitude. For a MoE model the CPU takes the
    card run's experts (as ``check_moe_plain``), its own probabilities
    giving the gates; the tokens its own router would send elsewhere are
    counted, each must be a near-tie, and the near-ties (NEAR_TIE) of both
    runs are counted."""
    cfg, sub = cut(params, full)
    batch = synth_batch(cfg, DataConfig(batch=1, seq_len=seq), 0,
                        device="cuda")
    if image is not None:
        batch["positions"], vision = image(1, seq)
        batch.update(vision)
    with _RouteLog() as card:
        lval, grads, got = _lm_grads(cfg, sub, batch)
    if got != _train_pass_counts(cfg, 1, seq):
        raise RuntimeError(f"{run}: the gradient launched {got}")
    t0 = time.perf_counter()
    # the CPU's plain path without remat: the same bits (tests/
    # test_torch_remat.py), one forward fewer on the host
    with _RouteLog(force=[i for _, i in card.routes]) as cpu:
        pval, pgrads, _ = _lm_grads(cfg.replace(remat=False),
                                    *_cpu_inputs(sub, batch))
    cpu_s = time.perf_counter() - t0
    # the card's forward routes; remat's recompute repeats them after
    card.routes = card.routes[:len(cpu.routes)]
    errs = _grad_errs(grads, pgrads)
    worst = max(errs, key=errs.get)
    routing = {}
    if card.routes:
        routing = dict(_route_flips(card.routes, cpu.routes),
                       near_ties_card=_near_ties(card.routes),
                       near_ties_cpu=_near_ties(cpu.routes),
                       near_tie=NEAR_TIE)
    line("lm_train", arch=full.arch_id, run=run, layers=cfg.n_layers,
         seq=seq, launches=got, image_tokens=int(
             batch["vision_mask"].sum()) if image is not None else 0,
         leaves=len(errs), loss=lval,
         cpu_loss=pval, worst_rel_err=errs[worst], worst_leaf=worst,
         rel_tol=LM_REL_TOL, cpu_plain_s=cpu_s, **routing)


def lm_grad_rounding(params, seeds=(0,)) -> None:
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
        _, pgrads, _ = _lm_grads(cfg.replace(remat=False),
                                 *_cpu_inputs(sub, batch))
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
    ("gemm_bwd", ("grouped_gemm_bwd",)),
    ("gemm_fwd", ("grouped_gemm_tc_kernel", "grouped_gemm_kernel")),
    ("ssd_bwd", ("chunk_state_kernel", "chunk_state_tc_kernel",
                 "state_scan_kernel", "chunk_grad_kernel",
                 "chunk_grad_tc_kernel", "group_sum_kernel",
                 "head_sum_kernel")),
    ("ssd_fwd", ("ssd_tc_kernel", "ssd_kernel")),
    ("rmsnorm_bwd", ("rmsnorm_bwd_kernel", "rmsnorm_bwd_vec_kernel",
                     "dw_sum_kernel", "dw_tree_sum_kernel")),
    ("rmsnorm_fwd", ("rmsnorm_kernel", "rmsnorm_vec_kernel")),
    ("flash_bwd", ("flash_bwd",)),
    ("flash_fwd", ("flash_fwd",)),
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


def profile_lm_train_step(params, opt, batch, seq, cfg=LM, ocfg=TRAIN_OCFG,
                          donate=False, fresh_cache=False) -> None:
    """One train step of ``cfg`` at batch x seq under torch.profiler, its
    device time split by kernel group; AdamW's device time apart, from a
    profile of ``adamw_update`` alone on that step's gradients (the rest of
    "other" is the model's elementwise work and the loss). With ``donate``
    both write ``params`` and ``opt`` in place, as ``ChainedTrainer``'s
    step does: the profiled steps train them on. With ``fresh_cache`` the
    allocator's cache is emptied before each step and before the
    gradients (``chained_run``'s), inside the profiled wall."""
    step_fn = make_train_step(cfg, ocfg, donate=donate)
    b = synth_batch(cfg, DataConfig(batch=batch, seq_len=seq), 100,
                    device="cuda")

    def step():
        if fresh_cache:
            torch.cuda.empty_cache()
        return step_fn(params, opt, b)
    rec = profile_device(f"{cfg.arch_id} train step {batch} x {seq}",
                         step, 1, "step", batch=batch, seq=seq,
                         fresh_cache=fresh_cache)
    groups = _group_ms(rec)
    if fresh_cache:
        torch.cuda.empty_cache()
    (_, _), grads = value_and_grad_aux(
        lambda p, bb: transformer.loss_fn(p, cfg, bb), params, b,
        has_aux=True)
    # a donated update empties the tree it is given: each call gets its
    # own containers of the same gradients
    adam = profile_device(f"adamw_update {cfg.arch_id}", lambda: adamw_update(
        tree_map(lambda g: g, grads), params, opt, ocfg, donate=donate), 1,
        "step", warmup=1)
    del grads
    groups["adamw"] = adam["device_ms_per_step"]
    groups["other_elementwise"] = groups.pop("other", 0.0) - groups["adamw"]
    line("lm_train", arch=cfg.arch_id,
         run=f"profile of one {batch} x {seq} step",
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


def _trainer_step(tr) -> float:
    """One step of ``ChainedTrainer`` ``tr``'s donated step function on
    its own data stream, as ``run_subjob`` takes it, without a sub-job's
    exit checkpoint (the chain's own run writes those,
    ``check_train_chain``): the loss."""
    batch = next(tr.data_iter)
    tr.params, tr.opt_state, metrics = tr.step_fn(tr.params, tr.opt_state,
                                                  batch)
    tr.step += 1
    return float(metrics["loss"])


def _shard_bytes(step_dir: Path) -> int:
    return sum(f.stat().st_size for f in step_dir.iterdir())


def check_train_chain() -> dict:
    """Mirage's sub-job chain at full width: ``repro_torch.launch.train``
    with no ``--arch`` (TinyLlama-1.1B, the reference's default) at its
    defaults, 8 x 128. Sub-job 1 runs CHAIN_STEPS[0] steps and ends in its
    exit checkpoint, the parameters and AdamW moments (13.2 GB) through the
    launcher's own writer; sub-job 2 resumes from it (``maybe_resume``,
    every leaf's digest checked) and runs CHAIN_STEPS[1] steps, ending in
    its own. Their losses against one uninterrupted run of the sum (the
    launcher's trainer built as ``launch.train`` builds it, its donated
    step driven straight through): the same bits. Every step one pass:
    each flash on the tensor cores both ways, each norm vectorised.
    ``[lm_train]`` lines: each save's wall time (``save()`` until
    ``wait()`` returns, the sub-job's ``exit_ckpt_s``), bytes and rate;
    the disk's raw write of the same bytes into the same directory; the
    restore's wall time; the host's resident set during each sub-job.
    Raises unless each save and the restore take at most CKPT_BUDGET_S
    or, where the disk's raw write takes longer than that, at most
    CKPT_DISK_FACTOR times it. Returns the sub-jobs' launches."""
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    ckpt = TRAIN_DIR / "chain"
    n1, n2 = CHAIN_STEPS
    t0 = time.perf_counter()
    _set_lm_train_counts()
    torch.cuda.reset_peak_memory_stats()
    subjobs = []
    for n in CHAIN_STEPS:
        with RssPeak() as rss:
            out = _launch(["--steps", str(n), "--ckpt-dir", str(ckpt)])
        subjobs.append((out, rss))
    peak = torch.cuda.max_memory_allocated() / 1e9
    got = _lm_train_counts()
    (first, rss1), (second, rss2) = subjobs
    if first["arch"] != DENSE.arch_id or first["resumed"] or \
            not second["resumed"] or second["steps_done"] != n1 + n2 or \
            got != _train_pass_counts(DENSE, n1 + n2, LAUNCHER_SEQ):
        raise RuntimeError(f"the chain at the launcher's defaults: "
                           f"{first['arch']}, resumed {first['resumed']} / "
                           f"{second['resumed']}, {second['steps_done']} "
                           f"steps, launched {got}")
    _set_lm_train_counts()
    tr = _chained_trainer(DENSE, TRAIN_OCFG, 8, LAUNCHER_SEQ)
    ref = [_trainer_step(tr) for _ in range(n1 + n2)]
    del tr
    torch.cuda.empty_cache()
    ref_counts = _lm_train_counts()
    losses = first["losses"] + second["losses"]
    if losses != ref or ref_counts != _train_pass_counts(
            DENSE, n1 + n2, LAUNCHER_SEQ):
        raise RuntimeError(f"the chain's losses {losses} against the "
                           f"uninterrupted run's {ref}; it launched "
                           f"{ref_counts}")
    shards = [_shard_bytes(ckpt / f"step_{s:09d}") for s in (n1, n1 + n2)]
    leaves = len(json.loads((ckpt / f"step_{n1:09d}" / "manifest.json")
                            .read_text())["leaves"])
    raw_s = raw_write_s(ckpt, shards[0])
    saves = [first["exit_ckpt_s"], second["exit_ckpt_s"]]
    slow_disk = raw_s > CKPT_BUDGET_S
    limit = CKPT_DISK_FACTOR * raw_s if slow_disk else CKPT_BUDGET_S
    for (out, rss), save_s, nbytes in zip(subjobs, saves, shards):
        line("lm_train", run="chain sub-job", arch=out["arch"],
             params=out["params"], batch=8, seq=LAUNCHER_SEQ,
             steps_done=out["steps_done"], resumed=out["resumed"],
             restore_s=out["resume_s"] if out["resumed"] else None,
             losses=_finite("the chain", out["losses"]),
             save_s=save_s, checkpoint_gb=nbytes / 1e9,
             save_gb_per_s=nbytes / 1e9 / save_s,
             codec=ckpt_mod.DEFAULT_CODEC,
             level=ckpt_mod.LEVELS[ckpt_mod.DEFAULT_CODEC],
             host_rss_start_gb=rss.start_gb, host_peak_rss_gb=rss.peak_gb)
    restore_s = second["resume_s"]
    line("lm_train", run="chain, resumed against uninterrupted",
         arch=DENSE.arch_id, steps=list(CHAIN_STEPS), losses=losses,
         uninterrupted=ref, bit_equal=True, leaves_digest_checked=leaves,
         save_s=saves, restore_s=restore_s,
         raw_write_s=raw_s, raw_write_gb=shards[0] / 1e9,
         raw_write_gb_per_s=shards[0] / 1e9 / raw_s,
         budget_s=limit, budget_by=(f"{CKPT_DISK_FACTOR}x the disk's raw "
                                    f"write" if slow_disk else
                                    f"{CKPT_BUDGET_S:.0f} s"),
         peak_gb=peak, wall_s=time.perf_counter() - t0, launches=got,
         **_host_memory())
    if max(saves + [restore_s]) > limit:
        raise RuntimeError(f"the full-width checkpoint: saves {saves} s, "
                           f"restore {restore_s} s, over {limit} s (raw "
                           f"write {raw_s} s)")
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return got


def lm_cut_train(cfg, run: str, draw=None, log=None, grad_seq=LM_GRAD_SEQ,
                 report=None) -> dict:
    """Training of ``cfg`` with seeded fp32 weights drawn on the card
    (``draw`` then redraws some of them): DENSE_TRAIN_RUN's steps after a
    warm-up through ``lm_train_run`` (ms a step, tokens/s, losses, peak
    memory, the launches a step checked), with ``log`` (a recorder class)
    entered around them and ``report(log, steps)`` giving the fields of a
    line on the cut (or raising); then the first 2 layers' gradients at 1 x
    ``grad_seq`` against the CPU plain path, and one step under
    torch.profiler by kernel group. Returns the run's launches."""
    t0 = time.perf_counter()
    state = _train_state(cfg, draw)
    n = sum(t.numel() for t in _leaves(state[0]))
    what, batch, seq, steps = DENSE_TRAIN_RUN
    with (log() if log else contextlib.nullcontext()) as seen:
        counts = lm_train_run(state, what, batch, seq, steps, cfg=cfg)
    params, opt = state
    del state
    if report is not None:
        line("lm_train", arch=cfg.arch_id, run=f"{run} cut",
             layers=cfg.n_layers, params=n, **report(seen, steps))
    del seen
    check_lm_train_grads(params, cfg, grad_seq)
    profile_lm_train_step(params, opt, batch, seq, cfg)
    del params, opt
    torch.cuda.empty_cache()
    line("lm_train", arch=cfg.arch_id, run=f"{run} training, all",
         wall_s=time.perf_counter() - t0)
    return counts


def dense_train() -> dict:
    """TinyLlama-1.1B training at its full published width and depth
    (``lm_cut_train``; every step 22 flash and 45 RMSNorm launches each
    way, all "tc" / "vec")."""
    return lm_cut_train(DENSE, "TinyLlama")


def gemma_train() -> dict:
    """Gemma-3-27B training at its full published width on GEMMA_TRAIN's 2
    layers, one local and one global (the cut's reason beside it), every
    norm scale drawn N(0, GEMMA_NORM_STD) (``lm_cut_train``; every step 2
    flash and 13 RMSNorm launches each way, all "tc" / "vec", one flash
    call of each with the window of 1024), the gradients checked at 1 x
    GEMMA_GRAD_SEQ, past the window."""
    def report(log, steps):
        # the warm-up step, then the timed ones: one local and one global,
        # twice under remat (the recompute calls the wrapper again)
        n = (steps + 1) * _passes(GEMMA_TRAIN)
        want = Counter({GEMMA.sliding_window: n, 0: n})
        if log.windows != want:
            raise RuntimeError(f"flash windows {dict(log.windows)}, "
                               f"not {want}")
        return dict(published_layers=gemma3_27b.CONFIG.n_layers,
                    plan=[[sg.n_repeat, list(sg.pattern)]
                          for sg in layer_plan(GEMMA_TRAIN)],
                    flash_windows_a_step={str(k): v // (steps + 1)
                                          for k, v in log.windows.items()})
    return lm_cut_train(GEMMA_TRAIN, "Gemma-3", _draw_gemma_norms,
                        _WindowLog, GEMMA_GRAD_SEQ, report)


def moe_train() -> dict:
    """Qwen1.5-MoE-A2.7B training at its full published width on
    QWEN_TRAIN's 3 of its 24 layers (the cut's reason beside it), the QKV
    biases drawn nonzero (``lm_cut_train``; every step a flash launch each
    way a layer, the routed experts' 2 grouped GEMMs a layer forward and
    one fused backward call each, all on the tensor cores, and 7 RMSNorm
    each way, vectorised), with the (token, k) pairs dropped at capacity
    and the router's near-ties."""
    _, batch, seq, _ = DENSE_TRAIN_RUN

    def report(log, steps):
        # routed pairs of every router call, remat's recompute among them
        pairs = ((steps + 1) * _passes(QWEN_TRAIN) * QWEN_TRAIN.n_layers
                 * batch * seq * QWEN.top_k)
        return dict(published_layers=QWEN.n_layers,
                    dropped=int(log.dropped), pairs=pairs,
                    dropped_share=int(log.dropped) / pairs,
                    capacity=_moe_capacity(seq),
                    rows_an_expert=batch * _moe_capacity(seq),
                    near_ties=_near_ties(log.routes),
                    qkv_bias_std=QKV_BIAS_STD)
    return lm_cut_train(QWEN_TRAIN, "Qwen2-MoE", _draw_qkv_bias, _RouteLog,
                        report=report)


def check_donation() -> dict:
    """The donated step on the card: TinyLlama-1.1B's first 2 layers at
    full width, seeded fp32 weights drawn on the card, one
    ``make_train_step`` step at 2 x 2048 run functional and donated from
    the same state: the same bits in every parameter, m and v leaf, the
    step counter and the metrics; the donated step returns the trees it
    was given, every leaf in its own storage (``data_ptr``). Returns the
    donated step's launches (one pass, checked)."""
    cfg = DENSE.replace(n_layers=LM_PLAIN_LAYERS)
    state = _train_state(cfg)
    mine = tree_map(torch.clone, state)
    ptrs = [t.data_ptr() for t in _leaves(mine)]
    _, batch, seq, _ = DENSE_TRAIN_RUN
    b = synth_batch(cfg, DataConfig(batch=batch, seq_len=seq), 7,
                    device="cuda")
    fp, fo, fm = make_train_step(cfg, TRAIN_OCFG)(*state, b)
    _set_lm_train_counts()
    dp, do, dm = make_train_step(cfg, TRAIN_OCFG, donate=True)(*mine, b)
    torch.cuda.synchronize()
    counts = _check_lm_train_counts("donated step", 1, cfg, seq)
    if dp is not mine[0] or do is not mine[1] or \
            [t.data_ptr() for t in _leaves([dp, do])] != ptrs:
        raise RuntimeError("the donated step did not keep its leaves")
    unequal = [path for (path, a), d in zip(_items([fp, fo]),
                                            _leaves([dp, do]))
               if a.dtype != d.dtype or not torch.equal(a, d)]
    metrics = {k: (float(fm[k]), float(dm[k])) for k in fm}
    if unequal or any(a != d for a, d in metrics.values()):
        raise RuntimeError(f"donated step differs from the functional one: "
                           f"{unequal[:5]}, {metrics}")
    line("lm_train", arch=cfg.arch_id, run="donated step against the "
         "functional one", layers=cfg.n_layers, batch=batch, seq=seq,
         leaves=len(ptrs), bit_identical=True, data_ptr_kept=True,
         loss=metrics["loss"][0], grad_norm=metrics["grad_norm"][0],
         launches=counts)
    del state, mine, fp, fo, dp, do
    torch.cuda.empty_cache()
    return counts


def _chained_trainer(cfg, ocfg, batch: int, seq: int, draw=None):
    """``ChainedTrainer`` of ``cfg`` on the card (its own seeded draw;
    ``draw`` then redraws some leaves) on ``data_iterator`` batches of
    batch x seq. Its steps are driven by ``_trainer_step``."""
    tr = train_chain.ChainedTrainer(
        cfg, ocfg, train_chain.ChainConfig(ckpt_dir=str(TRAIN_DIR),
                                           ckpt_every=10**9),
        data_iterator(cfg, DataConfig(batch=batch, seq_len=seq),
                      device="cuda"), seed=0, device="cuda")
    if draw is not None:
        draw(torch.Generator(device="cuda").manual_seed(1), tr.params)
    torch.cuda.synchronize()
    return tr


def chained_run(tr, what: str, batch: int, seq: int, steps: int,
                fresh_cache: bool = False, meta=None) -> dict:
    """``steps`` steps of the donated ``ChainedTrainer`` ``tr``
    (``_trainer_step``) after a warm-up step: host ms a step after
    ``synchronize``, tokens (frames) a second, the losses, the peak memory;
    raising unless each step's launches are one pass's
    (``_train_pass_counts``) and every parameter and optimizer leaf kept its
    storage. With ``fresh_cache`` the allocator's cache is emptied before
    each step, outside its time, so that every step allocates as the first
    one did (a step whose peak nears the card's memory can fail on the
    split blocks a previous step left). ``meta``: the step's peak counted
    on meta tensors first (``meta_step_peak``), printed beside the card's.
    Returns the launches of the ``steps`` steps."""
    cfg = tr.cfg
    if fresh_cache:
        torch.cuda.empty_cache()
    _trainer_step(tr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ptrs = [t.data_ptr() for t in _leaves([tr.params, tr.opt_state])]
    stats = torch.cuda.memory_stats()
    ms, losses, counts = [], [], Counter()
    for i in range(steps):
        _set_lm_train_counts()
        if fresh_cache:
            torch.cuda.empty_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(_trainer_step(tr))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        counts.update(_check_lm_train_counts(f"{what}, step {i}", 1, cfg,
                                             seq))
    counts = dict(counts)
    if [t.data_ptr() for t in _leaves([tr.params, tr.opt_state])] != ptrs:
        raise RuntimeError(f"{what}: a donated leaf moved")
    after = torch.cuda.memory_stats()
    line("lm_train", arch=cfg.arch_id, layers=cfg.n_layers, run=what,
         trainer="ChainedTrainer, donated", batch=batch, seq=seq,
         steps=steps, state_dtype=tr.ocfg.state_dtype or "float32",
         fresh_cache=fresh_cache, ms_per_step=_ms(ms), tokens_per_s=batch * seq / np.mean(ms) * 1e3,
         losses=_finite(what, losses), step=tr.step,
         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
         peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
         meta_step_peak_gb=None if meta is None else meta[0],
         meta_step_peak_op=None if meta is None else meta[1],
         allocator={k: after.get(k, 0) - stats.get(k, 0) for k in (
             "num_alloc_retries", "num_device_alloc", "num_device_free")},
         launches=counts)
    return counts


def _tree_gb(tree) -> float:
    return sum(t.numel() * t.element_size() for t in _leaves(tree)) / 1e9


def qwen4b_train() -> dict:
    """Qwen1.5-4B training at its full published width and depth
    (QWEN4B_TRAIN, all 40 layers) through ``ChainedTrainer``'s donated
    step, fp32 m and v, the QKV biases drawn nonzero, the step's peak
    counted on meta tensors first (``meta_step_peak``): DENSE_TRAIN_RUN's
    3 steps at 2 x 2048 (``chained_run``; every step a flash launch each
    way a layer, on the tensor cores, 20 q heads over 20 kv heads of 128,
    and 2 RMSNorm a layer + 1 each way, vectorised). Returns the
    launches."""
    what, batch, seq, steps = DENSE_TRAIN_RUN
    meta = meta_step_peak(QWEN4B_TRAIN, TRAIN_OCFG, batch, seq)
    t0 = time.perf_counter()
    tr = _chained_trainer(QWEN4B_TRAIN, TRAIN_OCFG, 2, LM_PROMPT,
                          _draw_qkv_bias)
    line("lm_train", arch=QWEN4B.arch_id, run="Qwen1.5-4B whole",
         layers=QWEN4B_TRAIN.n_layers, published_layers=QWEN4B.n_layers,
         params=sum(t.numel() for t in _leaves(tr.params)),
         param_gb=_tree_gb(tr.params), opt_state_gb=_tree_gb(tr.opt_state),
         qkv_bias_std=QKV_BIAS_STD, meta_step_peak_gb=meta[0],
         meta_step_peak_op=meta[1])
    counts = chained_run(tr, what, batch, seq, steps, meta=meta)
    del tr
    torch.cuda.empty_cache()
    line("lm_train", arch=QWEN4B.arch_id, run="Qwen1.5-4B training, all",
         wall_s=time.perf_counter() - t0)
    return counts


def hubert_run() -> dict:
    """HuBERT X-Large at its full published width and depth (48 layers, d
    1280, 16 heads of 80, LayerNorm, bidirectional, frames in), the
    weights ``ChainedTrainer`` draws on the card: ``forward`` and
    ``loss_fn`` on HUBERT_BATCH x HUBERT_FRAMES frames (timed after a
    warm-up; finite logits of the expected shape; a flash launch a layer
    each, non-causal, on the tensor cores in the Hopper form at its heads
    of 80, and nothing else: LayerNorm), 3 donated training steps at that
    batch (flash each way a layer, the forward twice with remat's
    recompute), and its first 2 layers' gradients against the CPU. Returns
    the steps' launches."""
    t0 = time.perf_counter()
    tr = _chained_trainer(HUBERT, TRAIN_OCFG, HUBERT_BATCH, HUBERT_FRAMES)
    b = synth_batch(HUBERT, DataConfig(batch=HUBERT_BATCH,
                                       seq_len=HUBERT_FRAMES), 100,
                    device="cuda")
    with torch.inference_mode():
        transformer.loss_fn(tr.params, HUBERT, b)
        torch.cuda.synchronize()
        _set_lm_train_counts()
        t1 = time.perf_counter()
        logits, _ = transformer.forward(tr.params, HUBERT, b["inputs"],
                                        b["positions"])
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t1) * 1e3
        t1 = time.perf_counter()
        loss, metrics = transformer.loss_fn(tr.params, HUBERT, b)
        torch.cuda.synchronize()
        loss_ms = (time.perf_counter() - t1) * 1e3
    counts = _lm_train_counts()
    flash = 2 * HUBERT.n_layers     # forward, then loss_fn
    want = {k: 0 for k in counts}
    want.update(flash_attention=flash, flash_tc=flash, flash_wg=flash)
    if fwd_form(HUBERT_FRAMES, HUBERT_FRAMES, HUBERT.hd) != "wg" \
            or counts != want:
        raise RuntimeError(f"HuBERT's forward and loss_fn launched {counts}, "
                           f"not {want}")
    want = (HUBERT_BATCH, HUBERT_FRAMES, HUBERT.vocab)
    if tuple(logits.shape) != want or not torch.isfinite(logits).all():
        raise RuntimeError(f"HuBERT logits {tuple(logits.shape)}, not {want}")
    line("hubert", arch=HUBERT.arch_id, run="forward and loss_fn",
         layers=HUBERT.n_layers, d_model=HUBERT.d_model, heads=HUBERT.nq,
         head_dim=HUBERT.hd, attn_impl=HUBERT.attn_impl,
         params=sum(t.numel() for t in _leaves(
             tr.params)), batch=HUBERT_BATCH, frames=HUBERT_FRAMES,
         logits_shape=list(logits.shape), forward_ms=fwd_ms,
         loss_fn_ms=loss_ms,
         frames_per_s=HUBERT_BATCH * HUBERT_FRAMES / fwd_ms * 1e3,
         loss=_finite("HuBERT loss", [float(loss)])[0],
         accuracy=float(metrics["accuracy"]), launches=counts)
    del logits
    counts = chained_run(tr, f"{HUBERT_BATCH} x {HUBERT_FRAMES} frames",
                         HUBERT_BATCH, HUBERT_FRAMES, DENSE_TRAIN_RUN[3])
    check_lm_train_grads(tr.params, HUBERT, HUBERT_FRAMES)
    del tr
    torch.cuda.empty_cache()
    line("hubert", arch=HUBERT.arch_id, run="HuBERT, all",
         wall_s=time.perf_counter() - t0)
    return counts


def _host_memory() -> dict:
    """This process's peak resident set and the host's memory, in GB."""
    with open("/proc/meminfo") as f:
        total = next(int(ln.split()[1]) for ln in f
                     if ln.startswith("MemTotal:"))
    return {"host_peak_rss_gb": resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 1e6, "host_mem_total_gb": total / 1e6}


def deepseek_train() -> dict:
    """DeepSeek-V2-236B training at its full published width on
    DEEPSEEK_TRAIN's 2 of its 60 layers (the dense first layer and one MoE
    layer), through ``ChainedTrainer``'s donated step with bf16 m and v,
    every norm scale drawn N(1, DEEPSEEK_NORM_STD): DEEPSEEK_TRAIN_RUN's 3
    steps at 1 x 2048 (``chained_run``; every step the routed experts' 2
    grouped GEMMs forward and 2 fused backward calls, all on the tensor
    cores, 9 RMSNorm each way, vectorised, no flash), the (token, k) pairs
    dropped at capacity; the 2 layers' gradients at 1 x DEEPSEEK_GRAD_SEQ
    against the CPU with the host's peak memory; one donated step under
    torch.profiler. Returns the run's launches."""
    t0 = time.perf_counter()
    tr = _chained_trainer(DEEPSEEK_TRAIN, DEEPSEEK_TRAIN_OCFG, 1,
                          LM_PROMPT, _draw_deepseek_norms)
    line("lm_train", arch=DEEPSEEK_TRAIN.arch_id, run="DeepSeek-V2 cut",
         layers=DEEPSEEK_TRAIN.n_layers,
         published_layers=deepseek_v2_236b.CONFIG.n_layers,
         plan=[[sg.n_repeat, list(sg.pattern)]
               for sg in layer_plan(DEEPSEEK_TRAIN)],
         params=sum(t.numel() for t in _leaves(tr.params)),
         param_gb=_tree_gb(tr.params),
         opt_state_gb=_tree_gb(tr.opt_state),
         state_dtype=DEEPSEEK_TRAIN_OCFG.state_dtype,
         norm_scale_std=DEEPSEEK_NORM_STD, init_s=time.perf_counter() - t0)
    what, batch, seq, steps = DEEPSEEK_TRAIN_RUN
    with _RouteLog() as log:
        counts = chained_run(tr, what, batch, seq, steps)
    moe_layers = DEEPSEEK_TRAIN.n_layers - DEEPSEEK_TRAIN.first_k_dense
    pairs = ((steps + 1) * _passes(DEEPSEEK_TRAIN) * moe_layers * batch
             * seq * DEEPSEEK.top_k)
    line("lm_train", arch=DEEPSEEK_TRAIN.arch_id,
         run="DeepSeek-V2 routing", dropped=int(log.dropped), pairs=pairs,
         dropped_share=int(log.dropped) / pairs,
         capacity=_moe_capacity(seq, DEEPSEEK), rows_an_expert=batch
         * _moe_capacity(seq, DEEPSEEK), near_ties=_near_ties(log.routes),
         gemm_bwd_by_variant={
             "tc": counts["gemm_bwd_tc"],
             "simt": counts["grouped_gemm_bwd_products"]
             - counts["gemm_bwd_tc"]})
    del log
    t1 = time.perf_counter()
    check_lm_train_grads(tr.params, DEEPSEEK_TRAIN, DEEPSEEK_GRAD_SEQ)
    line("lm_train", arch=DEEPSEEK_TRAIN.arch_id,
         run="2-layer gradient check, host memory",
         wall_s=time.perf_counter() - t1, **_host_memory())
    profile_lm_train_step(tr.params, tr.opt_state, batch, seq,
                          DEEPSEEK_TRAIN, DEEPSEEK_TRAIN_OCFG,
                          donate=True)
    del tr
    line("lm_train", arch=DEEPSEEK_TRAIN.arch_id,
         run="DeepSeek-V2 training, all", wall_s=time.perf_counter() - t0)
    return counts


def meta_step_peak(cfg, ocfg, batch: int, seq: int) -> tuple:
    """A donated train step of ``cfg`` at batch x seq run on meta tensors
    under ``StepCounter``: (the parameters' and optimizer state's GB plus
    the most the step allocates at once, the op that set it). The
    allocation order is the card's, without the caching allocator's
    rounding: the cut's memory before any card run."""
    params = transformer.init(MetaGenerator(), cfg)
    opt = init_opt_state(params, ocfg)
    b = {k: torch.zeros(batch, seq, dtype=torch.int32, device="meta")
         for k in ("inputs", "labels")}
    state = sum(t.numel() * t.element_size() for t in _leaves([params, opt]))
    with StepCounter(exclude=(params, opt, b)) as counter:
        make_train_step(cfg, ocfg, donate=True)(params, opt, b)
    return (state + counter.peak_bytes) / 1e9, counter.peak_op


def cmdr_train() -> dict:
    """Command-R 35B training at its full published width (d 8192, 64 q
    heads over 8 kv heads of 128, d_ff 22,528, the tied 256,000-row table,
    the parallel block, LayerNorm) on CMDR_TRAIN's cut of its 40 layers
    through ``ChainedTrainer``'s donated step with bf16 m and v, every
    LayerNorm scale drawn N(1, CMDR_NORM_STD) and bias N(0, CMDR_NORM_STD):
    the parameters held to the reference's count at that depth, the step's
    peak counted on meta tensors first (``meta_step_peak``);
    DENSE_TRAIN_RUN's 3 steps at 2 x 2048 (``chained_run``, each step from
    an emptied allocator cache: a second step whose peak nears the card's
    failed on the blocks the first had split; every step
    a flash launch a layer forward, again in remat's recompute, and one
    backward, all on the tensor cores, the backward's streaming form at
    one share of a kv head's group of 8; no RMSNorm: LayerNorm is plain
    PyTorch, as in the reference); the first 2 layers and the tied head at
    1 x CMDR_GRAD_SEQ against the CPU, with the host's peak memory; one
    donated step under torch.profiler by kernel group. Returns the run's
    launches."""
    torch.cuda.empty_cache()
    cfg = CMDR_TRAIN
    what, batch, seq, steps = DENSE_TRAIN_RUN
    meta_gb, meta_op = meta_step_peak(cfg, DEEPSEEK_TRAIN_OCFG, batch, seq)
    t0 = time.perf_counter()
    tr = _chained_trainer(cfg, DEEPSEEK_TRAIN_OCFG, batch, seq,
                          lambda gen, p: _draw_layer_norms(gen, p,
                                                           CMDR_NORM_STD))
    n = sum(t.numel() for t in _leaves(tr.params))
    if n != CMDR_TRAIN_PARAMS:
        raise RuntimeError(f"Command-R at {cfg.n_layers} layers has "
                           f"{n} parameters, not the reference's "
                           f"{CMDR_TRAIN_PARAMS}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    line("lm_train", arch=cfg.arch_id, run="Command-R cut",
         layers=cfg.n_layers, published_layers=command_r_35b.CONFIG.n_layers,
         params=n, param_gb=_tree_gb(tr.params),
         opt_state_gb=_tree_gb(tr.opt_state),
         state_dtype=DEEPSEEK_TRAIN_OCFG.state_dtype,
         parallel_block=cfg.parallel_block,
         tied_table=list(tr.params["embed"]["table"].shape),
         norm_std=CMDR_NORM_STD,
         flash_bwd_form=bwd_tc_form(seq, seq, cfg.nq, cfg.nkv, cfg.hd),
         flash_bwd_splits=bwd_splits(batch, seq, cfg.nkv,
                                     cfg.nq // cfg.nkv, sms),
         meta_step_peak_gb=meta_gb, meta_step_peak_op=meta_op,
         init_s=time.perf_counter() - t0)
    counts = chained_run(tr, what, batch, seq, steps, fresh_cache=True,
                         meta=(meta_gb, meta_op))
    t1 = time.perf_counter()
    torch.cuda.empty_cache()
    check_lm_train_grads(tr.params, cfg, CMDR_GRAD_SEQ)
    line("lm_train", arch=cfg.arch_id,
         run="2-layer gradient check, host memory",
         wall_s=time.perf_counter() - t1, **_host_memory())
    torch.cuda.empty_cache()
    profile_lm_train_step(tr.params, tr.opt_state, batch, seq, cfg,
                          DEEPSEEK_TRAIN_OCFG, donate=True, fresh_cache=True)
    del tr
    torch.cuda.empty_cache()
    line("lm_train", arch=cfg.arch_id, run="Command-R training, all",
         wall_s=time.perf_counter() - t0)
    return counts


def _with_image(data, image):
    """``data``'s batches, each with ``image``'s M-RoPE positions and
    vision inputs (``vl_image``) at its batch and length."""
    for b in data:
        b["positions"], vision = image(*b["inputs"].shape)
        b.update(vision)
        yield b


def vl_train() -> dict:
    """Qwen2-VL-7B training at its full published width on VL_TRAIN's cut
    of its 28 layers through ``ChainedTrainer``'s donated step, fp32 m and
    v, the QKV biases drawn nonzero, each 2 x 2048 batch with a 1,024-token
    image a row (VL_IMAGE): DENSE_TRAIN_RUN's 3 steps (``chained_run``;
    every step a flash launch each way a layer, on the tensor cores, 28 q
    heads over 4 kv heads of 128, its backward one share of the group of 7,
    and 2 RMSNorm a layer + 1 each way, vectorised); its first 2 layers'
    gradients at 1 x 512 with a 64-token image against the CPU. Returns the
    launches."""
    t0 = time.perf_counter()
    tr = _chained_trainer(VL_TRAIN, TRAIN_OCFG, 2, LM_PROMPT, _draw_qkv_bias)
    tr.data_iter = _with_image(tr.data_iter, vl_image(*VL_IMAGE))
    what, batch, seq, steps = DENSE_TRAIN_RUN
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    line("lm_train", arch=VL.arch_id, run="Qwen2-VL cut",
         layers=VL_TRAIN.n_layers, published_layers=VL.n_layers,
         params=sum(t.numel() for t in _leaves(tr.params)),
         param_gb=_tree_gb(tr.params), opt_state_gb=_tree_gb(tr.opt_state),
         qkv_bias_std=QKV_BIAS_STD, image=list(VL_IMAGE),
         flash_bwd_form=bwd_tc_form(seq, seq, VL.nq, VL.nkv, VL.hd),
         flash_bwd_splits=bwd_splits(batch, seq, VL.nkv, VL.nq // VL.nkv,
                                     sms))
    counts = chained_run(tr, what, batch, seq, steps)
    check_lm_train_grads(tr.params, VL_TRAIN, LM_GRAD_SEQ,
                         vl_image(*VL_PLAIN_IMAGE))
    del tr
    torch.cuda.empty_cache()
    line("lm_train", arch=VL.arch_id, run="Qwen2-VL training, all",
         wall_s=time.perf_counter() - t0)
    return counts


def _zamba_grad_sub(params, full=ZAMBA_TRAIN):
    """(config, tree) of Zamba2's first ZAMBA_GRAD_MAMBA Mamba blocks, each
    followed by the tied shared block (``attn_every`` 2: the block applied
    ZAMBA_GRAD_MAMBA times, its gradient the sum over the applications),
    same weights."""
    n = ZAMBA_GRAD_MAMBA
    cfg = full.replace(n_layers=2 * n, attn_every=2)
    seg = params["segments"][0]
    shared = layer_plan(full)[0].shared.index(True)
    return cfg, dict(params, segments=[{
        "b0": tree_map(lambda t: t[:n], seg["b0"]), "b1": seg[f"b{shared}"]}])


def zamba_train() -> dict:
    """Zamba2-7B training at its full published width on ZAMBA_TRAIN's cut
    of its 81 layers (5 groups of 6 Mamba2 blocks and the tied shared
    attention block, then 4 Mamba2 blocks) through ``ChainedTrainer``'s
    donated step, fp32 m and v, every norm scale drawn N(1,
    ZAMBA_NORM_STD), the step's peak counted on meta tensors first
    (``meta_step_peak``, printed beside the card's; the card's may not
    pass ZAMBA_TRAIN_PEAK_GB): DENSE_TRAIN_RUN's 3 steps at 2 x 2048
    (``chained_run``; every step 34 SSD scans each way, on the tensor
    cores, 79 RMSNorm each way, vectorised, the out_norms' 34 backwards
    at 896 vectors a row among them, and a flash launch each way an
    application of the shared block, its heads of 112 on the tensor cores
    in the Hopper form); a sub-model of 2 Mamba blocks each followed by
    the shared block, its gradients at 1 x 512 against the CPU (the tied
    leaves' the sum over both applications); one donated step under
    torch.profiler by kernel group. Returns the launches."""
    what, batch, seq, steps = DENSE_TRAIN_RUN
    meta = meta_step_peak(ZAMBA_TRAIN, TRAIN_OCFG, batch, seq)
    t0 = time.perf_counter()
    tr = _chained_trainer(ZAMBA_TRAIN, TRAIN_OCFG, 2, LM_PROMPT,
                          lambda gen, p: _draw_unit_norms(gen, p,
                                                          ZAMBA_NORM_STD))
    n = sum(t.numel() for t in _leaves(tr.params))
    if n != ZAMBA_TRAIN_PARAMS:
        raise RuntimeError(f"Zamba2-7B at {ZAMBA_TRAIN.n_layers} layers has "
                           f"{n} parameters, not the reference's "
                           f"{ZAMBA_TRAIN_PARAMS}")
    line("lm_train", arch=ZAMBA_TRAIN.arch_id, run="Zamba2 cut",
         layers=ZAMBA_TRAIN.n_layers,
         published_layers=zamba2_7b.CONFIG.n_layers,
         plan=[[sg.n_repeat, list(sg.pattern)]
               for sg in layer_plan(ZAMBA_TRAIN)],
         mamba_blocks=ZAMBA_TRAIN_MAMBA,
         shared_applications=ZAMBA_TRAIN.n_layers - ZAMBA_TRAIN_MAMBA,
         params=n, param_gb=_tree_gb(tr.params),
         opt_state_gb=_tree_gb(tr.opt_state), norm_scale_std=ZAMBA_NORM_STD,
         out_norm_bwd_warps_a_row=norm_ops.bwd_vec_split(
             ZAMBA_TRAIN.d_inner // 8),
         ssd_bwd_smem_bytes=ssd_ops.bwd_smem_bytes(
             ZAMBA_TRAIN.ssm_headdim, ZAMBA_TRAIN.ssm_state,
             ZAMBA_TRAIN.ssm_chunk, "tc"),
         meta_step_peak_gb=meta[0], meta_step_peak_op=meta[1],
         init_s=time.perf_counter() - t0)
    counts = chained_run(tr, what, batch, seq, steps, meta=meta)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if peak > ZAMBA_TRAIN_PEAK_GB:
        raise RuntimeError(f"Zamba2-7B at {ZAMBA_TRAIN.n_layers} layers "
                           f"peaked at {peak} GB, past {ZAMBA_TRAIN_PEAK_GB}")
    check_lm_train_grads(tr.params, ZAMBA_TRAIN, LM_GRAD_SEQ,
                         cut=_zamba_grad_sub,
                         run=f"{ZAMBA_GRAD_MAMBA} x (Mamba2 + the shared "
                             "block) gradient check")
    profile_lm_train_step(tr.params, tr.opt_state, batch, seq, ZAMBA_TRAIN,
                          donate=True)
    del tr
    torch.cuda.empty_cache()
    line("lm_train", arch=ZAMBA_TRAIN.arch_id, run="Zamba2 training, all",
         wall_s=time.perf_counter() - t0)
    return counts


def phase_lm_train() -> tuple:
    """Mamba2-1.3B training at full width with seeded weights drawn on the
    card: runs (a) and (b), one micro-batched step (c), the 2-layer
    gradient check, a profiled step; then TinyLlama-1.1B's training at 2 x
    2048 (``dense_train``), Gemma-3-27B's (``gemma_train``) and
    Qwen1.5-MoE-A2.7B's (``moe_train``) on cuts of their depth, the
    donated step against the functional one (``check_donation``),
    ``ChainedTrainer``'s donated runs of Qwen1.5-4B (``qwen4b_train``),
    HuBERT X-Large (``hubert_run``), DeepSeek-V2-236B (``deepseek_train``),
    Command-R 35B (``cmdr_train``),
    Qwen2-VL-7B (``vl_train``) and Zamba2-7B (``zamba_train``), the
    launcher at ``--smoke`` and the sub-job chain at the launcher's
    defaults (``check_train_chain``). Returns the launches of (a), (b),
    (c), the 2 x 2048 runs, the donated step, the ``ChainedTrainer`` runs
    and the chain, and each model run's own by its function's name."""
    torch.backends.cuda.matmul.allow_tf32 = False
    state = _train_state(LM)
    totals = defaultdict(int)
    for what, batch, seq, steps in LM_TRAIN_RUNS:
        for k, v in lm_train_run(state, what, batch, seq, steps).items():
            totals[k] += v
    params, opt = state
    del state
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
    runs = {}
    for train in (dense_train, gemma_train, moe_train, check_donation,
                  qwen4b_train, hubert_run, deepseek_train, cmdr_train,
                  vl_train,
                  zamba_train):
        runs[train.__name__] = train()
        for k, v in runs[train.__name__].items():
            totals[k] += v
    check_train_launcher()
    torch.cuda.empty_cache()
    for k, v in check_train_chain().items():
        totals[k] += v
    torch.cuda.empty_cache()
    return dict(totals), runs


# -------------------------------------------------------- 8b. examples
def _example(name: str, fn, *args) -> dict:
    """Run one example's ``main`` and print a line of its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    line("example", name=name, wall_s=time.perf_counter() - t0)
    return out


def phase_examples() -> dict:
    """The port's four examples (``repro_torch.examples``) on the card at
    the reference examples' defaults, each printing its own lines:
    quickstart (the control plane's two policies, then 20 training steps of
    TinyLlama's reduced config); train_lm twice on one checkpoint directory
    (the scaled config, 200 steps each), raising unless the loss falls in
    both and the second resumes at the first one's last step; serve_decode,
    raising unless all 6 requests finish; provision_service (a moe+dqn
    learner trained on the V100 heavy scenario, 3 sub-jobs of 10 payload
    steps through ``ChainedTrainer`` with a real checkpoint, the closing
    6-lane sweep), raising unless no payload step is lost across the
    sub-jobs and both sweeps' summaries are finite. Returns the phase's
    kernel launches, counted from 0 just before it."""
    shutil.rmtree(EXAMPLES_DIR, ignore_errors=True)
    _set_lm_train_counts()
    quick = _example("quickstart", ex_quickstart.main, [])
    losses = quick["data_plane"]["losses"]
    if len(losses) != 20 or not np.isfinite(losses).all():
        raise RuntimeError(f"quickstart's data plane: losses {losses}")
    args = ["--ckpt-dir", str(EXAMPLES_DIR / "train_lm")]
    first = _example("train_lm", ex_train_lm.main, args)
    second = _example("train_lm, resumed", ex_train_lm.main, args)
    if first["resumed"] or not second["resumed"] or \
            second["start_step"] != first["steps_done"] or \
            second["steps_done"] != 2 * first["steps_done"]:
        raise RuntimeError(f"train_lm: steps {first['steps_done']} then "
                           f"{second['start_step']}-{second['steps_done']}")
    for run in (first, second):
        if not np.isfinite(run["losses"]).all() or \
                run["last10"] >= run["first10"]:
            raise RuntimeError(f"train_lm: loss {run['first10']} -> "
                               f"{run['last10']}")
    served = _example("serve_decode", ex_serve_decode.main, [])
    if served["done"] != served["requests"] or served["requests"] != 6:
        raise RuntimeError(f"serve_decode: {served['done']} of "
                           f"{served['requests']} requests done")
    svc = _example("provision_service", ex_provision.main, [])
    summaries = (svc["summary"], svc["reactive_summary"])
    if svc["lost_steps"] or svc["total_steps"] != 10 * len(svc["subjobs"]) \
            or not all(np.isfinite(float(v)) for sm in summaries
                       for v in sm.values()):
        raise RuntimeError(f"provision_service: {svc['lost_steps']} payload "
                           f"steps lost of {svc['total_steps']}, summaries "
                           f"{summaries}")
    torch.cuda.synchronize()
    counts = _lm_train_counts()
    line("examples", quickstart_losses=losses,
         quickstart_summaries=quick["control_plane"]["summaries"],
         train_lm=[{k: run[k] for k in ("start_step", "steps_done",
                                        "first10", "last10", "tokens_per_s")}
                   for run in (first, second)],
         serve_decode={k: served[k] for k in ("requests", "done", "tokens",
                                              "seconds")},
         provision_service={k: svc[k] for k in (
             "method", "total_steps", "lost_steps", "summary",
             "reactive_summary", "reduction_pct")}, launches=counts)
    torch.cuda.empty_cache()
    return counts


# ------------------------------------- 8c. remat and the distributed launcher
REMAT_RUN = (2, 2048)      # TinyLlama's first 2 layers, one step each way
DIST_STEPS = (3, 2)        # the launcher's two sub-jobs in phase 8c
DRYRUN_CELL = ("tinyllama-1.1b", "train_4k")
DRYRUN_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dryrun"
DRYRUN_TIMEOUT_S = 900


def check_remat() -> dict:
    """Remat on the card: TinyLlama-1.1B's first 2 layers at full width,
    seeded fp32 weights drawn on the card, ``loss_fn``'s value and
    gradient on one 2 x 2048 batch with ``remat`` off, then on: the same
    loss and gradient bits (or the worst leaf's error, within
    LM_REL_TOL, reported), the peak memory each way over the weights and
    the batch, the ms of each after a warm-up, and the launches, checked:
    the forward kernels twice with remat (the recompute) but the final
    norm, the backward ones once either way. Returns the remat run's
    launches."""
    cfg = DENSE.replace(n_layers=LM_PLAIN_LAYERS)
    params = transformer.init(torch.Generator(device="cuda").manual_seed(0),
                              cfg)
    batch_n, seq = REMAT_RUN
    batch = synth_batch(cfg, DataConfig(batch=batch_n, seq_len=seq), 7,
                        device="cuda")
    runs, ms = {}, {"off": [], "on": []}
    _lm_grads(cfg, params, batch)           # warm-up, both ways' kernels
    for name in ("off", "on", "on", "off"):  # in turns: off, on, on, off
        c = cfg.replace(remat=name == "on")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        lval, grads, got = _lm_grads(c, params, batch)
        ms[name].append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated() - base
        if got != _train_pass_counts(c, 1, seq):
            raise RuntimeError(f"remat {name}: launched {got}, expected "
                               f"{_train_pass_counts(c, 1, seq)}")
        runs[name] = (lval, grads, got, peak)
        del grads
    (l0, g0, c0, p0), (l1, g1, c1, p1) = runs["off"], runs["on"]
    ms0, ms1 = ms["off"], ms["on"]
    unequal = [path for (path, a), b in zip(_items(g0), _leaves(g1))
               if not torch.equal(a, b)]
    worst = max((float((a - b).abs().max()) / (float(a.abs().max()) or 1.0)
                 for (_, a), b in zip(_items(g0), _leaves(g1))), default=0.0)
    if worst > LM_REL_TOL or not np.isfinite(l1):
        raise RuntimeError(f"remat changed the gradient: {worst} "
                           f"({unequal[:5]}), loss {l0} vs {l1}")
    if p1 >= p0:
        raise RuntimeError(f"remat did not lower the peak: {p1} >= {p0}")
    line("remat", arch=cfg.arch_id, layers=cfg.n_layers, batch=batch_n,
         seq=seq, loss_bit_equal=l0 == l1, grads_bit_equal=not unequal,
         unequal_leaves=len(unequal), worst_rel_err=worst,
         rel_tol=LM_REL_TOL, peak_gb_off=p0 / 1e9, peak_gb_on=p1 / 1e9,
         ms_off=ms0, ms_on=ms1, launches_off=c0, launches_on=c1)
    del params, batch, runs, g0, g1
    torch.cuda.empty_cache()
    return c1


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _launch(args) -> dict:
    """``launch.train.main(args)``, its lines printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_launcher.main(args)
    torch.cuda.synchronize()
    print(buf.getvalue(), end="", flush=True)
    return out


def check_distributed() -> dict:
    """``launch.train --distributed --arch tinyllama-1.1b`` at the
    launcher's defaults (8 x 128) on a world of one: NCCL through
    torchrun's variables, set here (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR 127.0.0.1 and a free port). Cut for time to the model's
    first 2 layers at full width (the registry hands the launcher that
    cut); every sub-job writes its exit checkpoint (2.6 GB) through the
    launcher's own writer. The plain launcher's sub-job of DIST_STEPS[0]
    steps against the distributed one; then a distributed sub-job resumed
    from the distributed one's checkpoint by ``restore_checkpoint(
    shardings=)`` on ``make_host_mesh()`` against a plain one resumed from
    a copy of it, DIST_STEPS[1] steps each: the same losses bit for bit,
    and no process group left. Returns the four sub-jobs' launches."""
    import torch.distributed as dist
    from repro_torch.models import registry
    cut = DENSE.replace(n_layers=LM_PLAIN_LAYERS)
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port())}
    saved_env = {k: os.environ.get(k) for k in env}
    real_cfg = registry.get_config
    ckpt, copy = TRAIN_DIR / "distributed", TRAIN_DIR / "plain_resumed"
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    _set_lm_train_counts()
    t0 = time.perf_counter()
    os.environ.update(env)
    registry.get_config = lambda arch, smoke=False: (
        cut if arch == DENSE.arch_id and not smoke else real_cfg(arch, smoke))
    try:
        first, second = (["--arch", DENSE.arch_id, "--steps", str(n),
                          "--ckpt-dir", str(ckpt)] for n in DIST_STEPS)
        plain1 = _launch(first[:-1] + [str(TRAIN_DIR / "plain")])
        dist1 = _launch(first + ["--distributed"])
        checkpoint_gb = sum(f.stat().st_size for f in ckpt.rglob("*")
                            if f.is_file()) / 1e9
        shutil.copytree(ckpt, copy)
        t_save = time.perf_counter()
        dist2 = _launch(second + ["--distributed"])
        plain2 = _launch(second[:-1] + [str(copy)])
    finally:
        registry.get_config = real_cfg
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    wall = time.perf_counter() - t0
    got = _lm_train_counts()
    n = sum(DIST_STEPS) * 2
    if got != _train_pass_counts(cut, n, LAUNCHER_SEQ) or \
            dist.is_initialized():
        raise RuntimeError(f"--distributed: launched {got} in {n} steps, "
                           f"group left: {dist.is_initialized()}")
    same = (plain1["losses"] == dist1["losses"]
            and dist2["losses"] == plain2["losses"])
    if not same or not (dist2["resumed"] and plain2["resumed"]) or \
            dist2["steps_done"] != sum(DIST_STEPS):
        raise RuntimeError(f"--distributed against the plain launcher: "
                           f"{plain1['losses']} / {dist1['losses']}, then "
                           f"{plain2['losses']} / {dist2['losses']}")
    line("distributed", arch=cut.arch_id, layers=cut.n_layers,
         params=dist1["params"], world=1, backend="nccl", batch=8, seq=128,
         steps=list(DIST_STEPS), losses_first=dist1["losses"],
         losses_resumed=dist2["losses"], bit_equal=same,
         resumed_at=DIST_STEPS[0], checkpoint_gb=checkpoint_gb,
         save_s=dist1["exit_ckpt_s"],
         restore_s=[dist2["resume_s"], plain2["resume_s"]],
         resume_and_steps_s=time.perf_counter() - t_save, wall_s=wall,
         launches=got)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    return got


def phase_remat_distributed() -> dict:
    """Phase 8c: ``check_remat`` and ``check_distributed``. Returns their
    launches."""
    totals = Counter(check_remat())
    totals.update(check_distributed())
    torch.cuda.empty_cache()
    return dict(totals)


def start_dryrun():
    """The dry run of DRYRUN_CELL (``repro_torch.launch.dryrun``) in a
    process of its own on the host, begun with the script so that it runs
    beside the card's phases: a fake process group of 256 ranks and meta
    tensors, no card (it sees none) and one thread."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    arch, shape = DRYRUN_CELL
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(DRYRUN_DIR)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def phase_dryrun(proc) -> None:
    """Phase 8d: wait for ``start_dryrun``'s process; raise unless it
    printed ``[ ok ]`` for its cell and exited 0; print its record."""
    t0 = time.perf_counter()
    out, _ = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
    arch, shape = DRYRUN_CELL
    oks = [ln for ln in out.splitlines() if ln.startswith("[ ok ]")]
    if proc.returncode or len(oks) != 1:
        raise RuntimeError(f"dry run of {arch} x {shape}: exit "
                           f"{proc.returncode}\n{out[-4000:]}")
    print(oks[0], flush=True)
    rec = json.loads((DRYRUN_DIR / f"{arch}__{shape}__16x16.json")
                     .read_text())
    line("dryrun", waited_s=time.perf_counter() - t0, record=rec)


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


def phase_timing(errs: dict, launches: dict, paths: dict) -> list:
    """Phase 5; ``paths``: the launches of phases 4h, 4i and 4j, by
    model, and of phase 8's runs, by function."""
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
    # too long for the short form take, at a long causal MHA shape beside
    # the CUDA-core variant and SDPA (the record of earlier PRs; phase 4c's
    # TinyLlama prefill runs the same form, timed below at its own shape)
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
    line("time", **time_flash_gqa(gen))
    line("time", **time_flash_gqa(gen, QWEN, "Qwen2-MoE"))
    line("time", **time_flash_gqa(gen, QWEN4B, "Qwen1.5-4B"))
    line("time", **time_flash_gqa(gen, GEMMA, "Gemma-3 local",
                                  GEMMA.sliding_window))
    line("time", **time_flash_gqa(gen, GEMMA, "Gemma-3 global"))
    cmdr = time_flash_gqa(gen, CMDR, "Command-R")
    line("time", **cmdr, launches_a_prefill=CMDR.n_layers,
         launches=paths["cmdr"]["flash_attention"])
    # the Hopper streaming form (flash_fwd_wg_kernel) as a kernel of its
    # own, every LM path's launches of it, timed at Command-R's layer
    wg_rec = _kernel_record(cmdr, "src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:33",
                            launches["flash_wg"], errs["flash_attention_wg"],
                            keep=WG_KEYS,
                            name="flash_attention, Hopper streaming form")
    line("time", **time_flash_gqa(gen, VL, "Qwen2-VL"),
         launches_a_prefill=VL.n_layers,
         launches=paths["vl"]["flash_attention"])
    # the two layers whose head dims the Hopper form runs on its D = 128
    # kernels, the columns past D read as zeros: Zamba2-7B's shared block
    # (phase 4h: an application a group) and HuBERT X-Large's encoder
    # (phase 8: a layer each forward, at its 4 x 1000 frames, non-causal)
    layer_recs = [
        _kernel_record(time_flash_gqa(gen, ZAMBA, "Zamba2-7B shared block"),
                       "src/repro_torch/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention/kernel.py:33",
                       paths["zamba"]["flash_attention"],
                       errs["flash_case"][ZAMBA_FLASH_CASE],
                       launches_a_prefill=ZAMBA_ATTN),
        _kernel_record(time_flash_gqa(gen, HUBERT, "HuBERT X-Large",
                                      causal=False, B=HUBERT_BATCH,
                                      S=HUBERT_FRAMES),
                       "src/repro_torch/csrc/flash_attention.cu",
                       "src/repro/kernels/flash_attention/kernel.py:33",
                       paths["hubert_run"]["flash_attention"],
                       errs["flash_case"][HUBERT_FLASH_CASE],
                       name="flash_attention HuBERT X-Large layer",
                       launches_a_step=2 * HUBERT.n_layers)]
    for rec in layer_recs:
        line("time", **rec)
    # RMSNorm as Gemma-3's QK-norm (its 32 q heads' rows of 128) and as
    # DeepSeek-V2's q_norm and kv_norm run at a 4 x 2048 prefill
    rows = LM_BATCH * LM_PROMPT
    line("time", **time_norm(gen, "rmsnorm Gemma-3 QK-norm",
                             rows * GEMMA.nq, GEMMA.hd, True,
                             GEMMA.norm_eps, GEMMA_NORM_STD))
    for what, dim in (("q_norm", DEEPSEEK.q_lora_rank),
                      ("kv_norm", DEEPSEEK.kv_lora_rank)):
        line("time", **time_norm(gen, f"rmsnorm DeepSeek-V2 {what}", rows,
                                 dim, False, DEEPSEEK.norm_eps,
                                 DEEPSEEK_NORM_STD))
    # RMSNorm at Zamba2-7B's d_model (its Mamba blocks' ln, the shared
    # block's ln1 and ln2, the final norm) and its out_norms' d_inner, and
    # the scan at one of its prefill layers (phase 4h)
    for what, dim, n in (("d_model", ZAMBA.d_model, ZAMBA_NORMS - ZAMBA_MAMBA),
                         ("out_norm", ZAMBA.d_inner, ZAMBA_MAMBA)):
        line("time", **time_norm(gen, f"rmsnorm Zamba2-7B {what}", rows, dim,
                                 False, ZAMBA.norm_eps, ZAMBA_NORM_STD),
             launches_a_prefill=n, launches=paths["zamba"]["rmsnorm"])
    line("time", **time_ssd(gen, ZAMBA, "Zamba2-7B"),
         launches_a_prefill=ZAMBA_MAMBA, launches=paths["zamba"]["ssd"])
    for rec in (time_moe_gemms(gen)
                + time_moe_gemms(gen, DEEPSEEK, "DeepSeek-V2")):
        line("time", **rec)

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
    return [flash_rec, wg_rec, gemm_rec, norm_rec, ssd_rec] + time_backward(
        gen, errs, launches) + time_lm_backward(gen, errs, launches, paths) \
        + layer_recs


# the keys a Hopper streaming form's record keeps of its phase 5 row
WG_KEYS = ("ms", "old_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
           "shape")


def _kernel_record(t, source, replaces, n, err, keep=None, **kw) -> dict:
    """The kernels-line record of a phase 5 ``[time]`` row ``t`` (its keys
    in ``keep``, or all), with ``n`` launches on the main path, raising if
    none, and ``err``, the kernel's error in phase 2 (at a model's layer:
    its case at that layer's shape); ``kw`` adds keys or replaces them."""
    name = kw.get("name", t.get("name"))
    if not n:
        raise RuntimeError(f"{name}: no path launched it")
    t = t if keep is None else {k: t[k] for k in keep}
    return dict(t, route="cuda", source=source, replaces=replaces,
                launches=n, max_abs_err=err, **kw)


def _padded(D: int) -> dict:
    """The Hopper form's padding at head dim D: the kernel width it runs
    on (64 or 128, the columns past D read as zeros) and its products
    over the head's own."""
    width = 64 if D <= 64 else 128
    return {"kernel_width": width, "padded_product_factor": width / D}


def time_flash_gqa(gen, cfg=DENSE, what="TinyLlama", window=0, causal=True,
                   B=LM_BATCH, S=LM_PROMPT) -> dict:
    """Flash at one prefill layer of ``cfg``, (4,2048) causal, bf16 (for
    TinyLlama 32 q heads over 4 kv heads of 64, phase 4c's path; for
    Qwen2-MoE 16 over 16 of 128, phase 4d's; for Gemma-3 32 over 16 of 128,
    phase 4e's, its local layers with ``window``; for Zamba2-7B's shared
    block 32 over 32 of 112, phase 4h's; HuBERT X-Large's encoder layer at
    its (4,1000) frames, 16 over 16 of 80, non-causal): the form the
    wrapper runs (``form``: the Hopper streaming form; at a head dim off 64
    and 128 on its wider kernel, ``_padded``) beside the mma.sync
    streaming form (``old_ms``), the CUDA-core variant, the plain version
    and SDPA with ``enable_gqa`` (with a window, one SDPA call with the
    band as its boolean ``attn_mask``). The bound counts k and v at their
    own heads and the products of the (q, k) pairs the masks leave
    visible, at the head's own D."""
    Hq, Hkv, D = cfg.nq, cfg.nkv, cfg.hd
    q, k, v = flash_inputs(gen, B, S, S, Hq, Hkv, D, torch.bfloat16)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def gqa():
        return flash_attention(q, k, v, causal=causal, window=window)
    ms, variant = timed_variant(flash_attention, gqa)
    old_ms = time_ms(lambda: flash_launch(
        q, k, v, "tc", causal=causal, window=window, softcap=0.0,
        scale=D ** -0.5, form="stream"))
    # visible keys of query p: p + 1 (causal) or S, at most the window
    seen = torch.arange(1, S + 1) if causal else torch.full((S,), S)
    if window:
        seen = seen.clamp(max=window)
    pairs = B * Hq * int(seen.sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    bms, by = bound_ms(nbytes, 4 * pairs * D)
    if window:
        qp = torch.arange(S, device="cuda")[:, None]
        kp = torch.arange(S, device="cuda")[None, :]
        band = (kp <= qp) & (qp - kp < window)

        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True)
        lib = "F.scaled_dot_product_attention(attn_mask=band, enable_gqa=True)"
    else:
        def library():
            return F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib = "F.scaled_dot_product_attention(enable_gqa=True)"
    lib_ms = time_ms(library)
    return dict(
        name=f"flash_attention {what} prefill layer",
        shape=f"q ({B},{S},{Hq},{D}), k,v ({B},{S},{Hkv},{D}) bf16, "
              + ("causal" if causal else "non-causal")
              + (f", window {window}" if window else ""),
        variant=variant, form=fwd_form(S, S, D), ms=ms, old_ms=old_ms,
        old_form="stream",
        plain_ms=time_ms(lambda: flash_attention_ref(
            q, k, v, causal=causal, window=window), reps=3),
        library_ms=lib_ms, library=lib, library_factor=ms / lib_ms,
        simt_ms=time_ms(lambda: flash_launch(
            q, k, v, "simt", causal=causal, window=window, softcap=0.0,
            scale=D ** -0.5), reps=3),
        host_us=host_us(gqa), bound_ms=bms, bound_by=by,
        bound_share=bms / ms, bytes=nbytes, flops=4 * pairs * D,
        visible_pairs_a_head=pairs // (B * Hq), **_padded(D))


def time_norm(gen, name: str, rows: int, dim: int, gemma: bool,
              eps: float, w_std: float) -> dict:
    """RMSNorm at (rows, dim) bf16, w fp32 (drawn N(0, w_std), or N(1,
    w_std) without ``gemma``), as a prefill runs it: beside "simt", the
    plain version and ``F.rms_norm`` with the weight it applies (1 + w
    with ``gemma``) in bf16, the library's fused path. The bound: x read
    and y written once."""
    x = _randn(gen, (rows, dim), torch.bfloat16, 3.0)
    w = _randn(gen, (dim,), torch.float32, w_std)
    if not gemma:
        w += 1.0
    w_lib = ((1.0 + w) if gemma else w).to(torch.bfloat16)

    def norm():
        return rmsnorm(x, w, eps=eps, gemma=gemma)
    ms, variant = timed_variant(rmsnorm, norm)
    nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
    bms, by = bound_ms(nbytes, 4 * x.numel(), FP32_FLOP_PER_S)
    lib_ms = time_ms(lambda: F.rms_norm(x, (dim,), w_lib, eps))
    return dict(
        name=name, shape=f"({rows},{dim}) bf16, w fp32"
        + (", gemma" if gemma else ""), variant=variant, ms=ms,
        simt_ms=time_ms(lambda: norm_launch(x, w, "simt", eps=eps,
                                            gemma=gemma)),
        plain_ms=time_ms(lambda: rmsnorm_ref(x, w, eps=eps, gemma=gemma),
                         reps=5),
        library_ms=lib_ms,
        library="F.rms_norm(weight=1 + w)" if gemma else "F.rms_norm",
        library_factor=ms / lib_ms, host_us=host_us(norm), bound_ms=bms,
        bound_by=by, bound_share=bms / ms, bytes=nbytes)


def time_ssd(gen, cfg, what: str) -> dict:
    """The scan of one prefill layer of ``cfg`` (4 x 2048, bf16) beside
    its "simt" variant and plain version, with its bound (no one PyTorch
    call scans)."""
    shape = (LM_BATCH, LM_PROMPT, cfg.ssm_nheads, cfg.ssm_headdim,
             cfg.ssm_state, cfg.ssm_ngroups)
    args = ssd_inputs(gen, *shape, torch.bfloat16, False)[:6]

    def scan():
        return ssd(*args, cfg.ssm_chunk)
    ms, variant = timed_variant(ssd, scan)
    bms, by = bound_ms(*ssd_work(*shape, cfg.ssm_chunk, 2))
    return dict(
        name=f"ssd {what} prefill layer",
        shape=f"x ({LM_BATCH},{LM_PROMPT},{cfg.ssm_nheads},"
              f"{cfg.ssm_headdim}) bf16, B/C ({LM_BATCH},{LM_PROMPT},"
              f"{cfg.ssm_ngroups},{cfg.ssm_state}) bf16, chunk "
              f"{cfg.ssm_chunk}", variant=variant, ms=ms,
        simt_ms=time_ms(lambda: ssd_launch(*args, cfg.ssm_chunk, None,
                                           "simt"), reps=5),
        plain_ms=time_ms(lambda: ssd_ref(*args, cfg.ssm_chunk), reps=5),
        library_ms=None, host_us=host_us(scan), bound_ms=bms, bound_by=by,
        bound_share=bms / ms)


def time_moe_gemms(gen, cfg=QWEN, model="Qwen2-MoE") -> list:
    """The routed experts' grouped GEMMs of ``cfg`` (Qwen2-MoE: E = 60, a
    4 x 2048 prefill's 684 rows an expert; DeepSeek-V2: E = 160, 384 rows)
    and at a decode step's 4, bf16, wi then wo: the kernel beside its plain
    version and ``torch.bmm``, with the bound (x and w read, out written
    once; 2 x rows x d x f products an expert) and the kernel's share of
    it."""
    recs = []
    E = cfg.n_experts
    for what, C, din, dout in _moe_gemm_shapes(cfg):
        x, w = gemm_inputs(gen, E, C, din, dout, torch.bfloat16)
        ms, variant = timed_variant(grouped_gemm, lambda: grouped_gemm(x, w))
        nbytes = (x.numel() + w.numel() + x.shape[0] * C * dout) * 2
        flops = 2 * x.shape[0] * C * din * dout
        bms, by = bound_ms(nbytes, flops)
        recs.append(dict(
            name=f"grouped_gemm {model} {what}",
            shape=f"({E},{C},{din})x({E},{din},{dout}) bf16",
            variant=variant, ms=ms,
            plain_ms=time_ms(lambda: grouped_gemm_ref(x, w), reps=5),
            library_ms=time_ms(lambda: torch.bmm(x, w)), library="torch.bmm",
            host_us=host_us(lambda: grouped_gemm(x, w)), bound_ms=bms,
            bound_by=by, bound_share=bms / ms, bytes=nbytes, flops=flops))
        del x, w
    return recs


def time_flash_bwd_lm(gen, cfg, what: str, window=0, causal=True, B=2,
                      S=LM_PROMPT) -> dict:
    """The flash backward at one training layer of ``cfg``, (2,2048)
    causal, bf16 (TinyLlama: 32 q heads over 4 kv heads of 64; Qwen2-MoE:
    16 over 16 of 128; Gemma-3: 32 over 16 of 128, its local layers with
    ``window``; Zamba2-7B's shared block: 32 over 32 of 112; HuBERT
    X-Large: 16 over 16 of 80 at its (4,1000) frames, non-causal), from
    the forward's out and lse: the variant
    ``_flash_bwd_variant`` picks (the tensor cores' Hopper streaming form,
    ``form``, at ``splits`` shares of a kv head's q heads) beside the
    mma.sync streaming form it replaced at its own split rule (``old_ms``,
    ``old_splits``), the "simt" kernels at the same shape, its plain
    version and SDPA's backward (``enable_gqa`` where the heads are
    grouped; with a window, the band as its boolean ``attn_mask``); where
    a kv head has several q heads, the Hopper form again at every share
    count up to the group (``splits_ms``). The bound: q, o, dO, dq at the
    q heads and k, v, dk, dv at the kv heads read or written once; five
    products (q.k^T again, dP, dV, dQ, dK) over the (q, k) pairs the masks
    leave visible, at the head's own D."""
    Hq, Hkv, D = cfg.nq, cfg.nkv, cfg.hd
    q, k, v = flash_inputs(gen, B, S, S, Hq, Hkv, D, torch.bfloat16)
    do = _randn(gen, q.shape, torch.bfloat16)
    o, lse = flash_launch(q, k, v, _flash_variant(q, k, v), causal=causal,
                          window=window, softcap=0.0, scale=D ** -0.5,
                          lse=True)

    def bwd():
        return flash_attention_bwd(q, k, v, o, lse, do, causal=causal,
                                   window=window)
    ms, variant = timed_variant(flash_attention_bwd, bwd, reps=10)
    run = dict(causal=causal, window=window, softcap=0.0, scale=D ** -0.5)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    form = bwd_tc_form(S, S, Hq, Hkv, D)
    extra = {"form": form,
             "splits": bwd_splits(B, S, Hkv, Hq // Hkv, sms, form),
             "old_ms": time_ms(lambda: flash_launch_bwd(
                 q, k, v, o, lse, do, "tc", form="stream", **run), reps=10),
             "old_form": "stream",
             "old_splits": bwd_splits(B, S, Hkv, Hq // Hkv, sms, "stream")}
    if Hq > Hkv:
        extra["splits_ms"] = {n: time_ms(lambda n=n: flash_launch_bwd(
            q, k, v, o, lse, do, "tc", splits=n, **run), reps=10)
            for n in range(1, Hq // Hkv + 1)}
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    if window:
        qp = torch.arange(S, device="cuda")[:, None]
        kp = torch.arange(S, device="cuda")[None, :]
        sdpa = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=(kp <= qp) & (qp - kp < window),
            enable_gqa=Hq != Hkv)
        lib = "(attn_mask=band, enable_gqa=True)"
    else:
        sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=Hq != Hkv)
        lib = "(enable_gqa=True)" if Hq != Hkv else ""
    dot = do.transpose(1, 2).contiguous()
    # visible keys of query p: p + 1 (causal) or S, at most the window
    seen = torch.arange(1, S + 1) if causal else torch.full((S,), S)
    if window:
        seen = seen.clamp(max=window)
    pairs = B * Hq * int(seen.sum())
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    flops = 5 * 2 * pairs * D
    bms, by = bound_ms(nbytes, flops)
    lib_ms = time_ms(lambda: torch.autograd.grad(
        sdpa, (qt, kt, vt), dot, retain_graph=True))
    return dict(
        name=f"flash_attention_bwd {what} training layer",
        shape=f"q,o,dO ({B},{S},{Hq},{D}), k,v ({B},{S},{Hkv},{D}) bf16, "
              + ("causal" if causal else "non-causal")
              + (f", window {window}" if window else ""),
        variant=variant, ms=ms,
        simt_ms=time_ms(lambda: flash_launch_bwd(q, k, v, o, lse, do,
                                                 "simt", **run), reps=3),
        plain_ms=time_ms(lambda: flash_attention_bwd_ref(
            q, k, v, o, lse, do, causal=causal, window=window), reps=3),
        library_ms=lib_ms,
        library=f"F.scaled_dot_product_attention{lib} backward",
        library_factor=ms / lib_ms, host_us=host_us(bwd, reps=10),
        bound_ms=bms, bound_by=by, bound_share=bms / ms, bytes=nbytes,
        flops=flops, visible_pairs_a_head=pairs // (B * Hq), **extra,
        **_padded(D))


def time_gemm_bwd_lm(gen, shapes, model) -> list:
    """The grouped GEMM backward at an MoE model's training shapes, wi then
    wo (``shapes``: ``_moe_train_gemms``'s (what, E, rows an expert, d_in,
    d_out)): dX and dW
    through autograd (one fused launch a projection) beside the two-launch
    route (``old_ms``), the plain version and two ``torch.bmm`` on
    transposed views, with the bound (x, w, dy read and dx, dw written
    once; 2 x 2 x rows x d x f products an expert)."""
    recs = []
    for what, E, C, din, dout in shapes:
        x, w = (t_.requires_grad_(True) for t_ in gemm_inputs(
            gen, E, C, din, dout, torch.bfloat16))
        dy = _randn(gen, (E, C, dout), torch.bfloat16)
        out = grouped_gemm(x, w)

        def bwd():
            return torch.autograd.grad(out, (x, w), dy, retain_graph=True)
        n, calls = grouped_gemm.bwd_tc_launches, grouped_gemm.bwd_fused_calls
        ms = time_ms(bwd)
        n, calls = (grouped_gemm.bwd_tc_launches - n,
                    grouped_gemm.bwd_fused_calls - calls)
        xd, wd = x.detach(), w.detach()
        lib_ms = time_ms(lambda: (torch.bmm(dy, wd.transpose(1, 2)),
                                  torch.bmm(xd.transpose(1, 2), dy)))
        nbytes = 2 * (2 * x.numel() + 2 * w.numel() + dy.numel())
        flops = 2 * 2 * E * C * din * dout
        bms, by = bound_ms(nbytes, flops)
        recs.append(dict(
            name=f"grouped_gemm_bwd {model} training {what}",
            shape=f"dX, dW of ({E},{C},{din})x({E},{din},{dout}) bf16",
            variant="tc" if n == 2 * calls and calls else "mixed", ms=ms,
            old_ms=time_ms(lambda: gemm_ops._backward_two_launches(
                xd, wd, dy, True, True)),
            plain_ms=time_ms(lambda: grouped_gemm_bwd_ref(xd, wd, dy),
                             reps=3),
            library_ms=lib_ms, library="two torch.bmm",
            library_factor=ms / lib_ms, splits=gemm_ops.split_count(
                E, din, dout, C,
                torch.cuda.get_device_properties(0).multi_processor_count),
            bound_ms=bms, bound_by=by, bound_share=bms / ms, bytes=nbytes,
            flops=flops))
        del x, w, dy, out, xd, wd
    return recs


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
    t = {"ms": ms, "form": bwd_tc_form(HISTORY, HISTORY, H, H, D),
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
    line("time", **time_flash_bwd_lm(gen, DENSE, "TinyLlama"))
    line("time", **time_flash_bwd_lm(gen, QWEN, "Qwen2-MoE"))
    line("time", **time_flash_bwd_lm(gen, QWEN4B, "Qwen1.5-4B"))
    line("time", **time_flash_bwd_lm(gen, VL, "Qwen2-VL"),
         launches_a_step=VL_TRAIN.n_layers)
    line("time", **time_flash_bwd_lm(gen, GEMMA, "Gemma-3 local",
                                     window=GEMMA.sliding_window))
    line("time", **time_flash_bwd_lm(gen, GEMMA, "Gemma-3 global"))
    for model, cfg, batch in MOE_TRAIN_GEMMS:
        for rec in time_gemm_bwd_lm(gen, _moe_train_gemms(cfg, batch),
                                    model):
            line("time", **rec)
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


def time_norm_bwd(gen, name: str, shape: str, rows: int, dim: int,
                  norms: int, gemma: bool, eps: float, w_std: float) -> dict:
    """RMSNorm's backward over ``norms`` norms of (rows, dim) bf16, w fp32
    drawn N(0, w_std) with ``gemma`` (the weight applied is 1 + w), else
    N(1, w_std), as a training step runs them (Gemma-3: a layer's four block
    norms at 2 x 2048, 672 vectors a row; DeepSeek-V2: its q_norm or
    kv_norm at 1 x 2048): the vec kernel beside "simt", the plain version
    and autograd through ``F.rms_norm`` with the applied weight in bf16.
    The bound: x and dy read and dx written once a norm, dw's fp32 sums."""
    args = []
    for _ in range(norms):
        w = _randn(gen, (dim,), torch.float32, w_std)
        args.append((_randn(gen, (rows, dim), torch.bfloat16, 3.0),
                     w if gemma else 1.0 + w,
                     _randn(gen, (rows, dim), torch.bfloat16)))

    def bwd():
        return [rmsnorm_bwd(x, w, dy, eps=eps, gemma=gemma)
                for x, w, dy in args]
    n_all, n_fast = rmsnorm.bwd_launches, rmsnorm.bwd_vec_launches
    ms = time_ms(bwd)
    variant = _bwd_variant(lambda: (rmsnorm.bwd_launches,
                                    rmsnorm.bwd_vec_launches),
                           n_fast, n_all, "vec")
    libs = []
    for x, w, dy in args:
        xl = x.clone().requires_grad_(True)
        wl = ((1.0 + w) if gemma else w).to(torch.bfloat16).requires_grad_(
            True)
        libs.append((F.rms_norm(xl, (dim,), wl, eps), xl, wl, dy))
    lib_ms = time_ms(lambda: [torch.autograd.grad(y, (xl, wl), dy,
                                                  retain_graph=True)
                              for y, xl, wl, dy in libs])
    nbytes = norms * (3 * rows * dim * 2 + 2 * dim * 4)
    flops = norms * 10 * rows * dim
    bms, by = bound_ms(nbytes, flops, FP32_FLOP_PER_S)
    return dict(
        name=name, shape=shape, variant=variant, ms=ms,
        simt_ms=time_ms(lambda: [norm_launch_bwd(
            x, w, dy, "simt", eps=eps, gemma=gemma) for x, w, dy in args]),
        plain_ms=time_ms(lambda: [rmsnorm_bwd_ref(
            x, w, dy, eps=eps, gemma=gemma) for x, w, dy in args], reps=3),
        library_ms=lib_ms, library="autograd through F.rms_norm"
        + ("(weight=1 + w)" if gemma else ""),
        library_factor=ms / lib_ms, host_us=host_us(bwd), bound_ms=bms,
        bound_by=by, bound_share=bms / ms, bytes=nbytes, flops=flops)


def time_lm_backward(gen, errs: dict, launches: dict, paths: dict) -> list:
    """The RMSNorm and SSD backward kernels at phase 8's (b) shapes: one
    Mamba2 layer's two norm backwards, (4096,2048) and (4096,4096) bf16 with
    an fp32 w, and its scan's backward, x (2,2048,64,64) bf16, N=128,
    chunk 256; the variant the wrapper picks (``ms``) beside the other one
    at the same shapes (``simt_ms``: the strided-column norm backward, the
    CUDA-core scan backward), their plain versions, the library's
    (autograd through ``F.rms_norm``; none for the scan) and the bound;
    then the norm backward at Gemma-3's, DeepSeek-V2's, Qwen2-VL's and
    Zamba2-7B's training shapes (its out_norm, (4096,7168), 896 vectors a
    row) and the scan's backward at Zamba2-7B's training layer, x
    (2,2048,112,64), N = 64, and the flash backward at Command-R's
    training layer, (2,2048,64/8,128) (``paths``: the launches of phase 8's
    runs)."""
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
    line("time", **time_norm_bwd(
        gen, "rmsnorm_bwd Gemma-3 block norms",
        f"4 x ({rows},{GEMMA.d_model}) bf16, w fp32, gemma: one training "
        "layer's ln1, post_ln1, ln2, post_ln2", rows, GEMMA.d_model, 4, True,
        GEMMA.norm_eps, GEMMA_NORM_STD))
    for what, dim in (("q_norm", DEEPSEEK.q_lora_rank),
                      ("kv_norm", DEEPSEEK.kv_lora_rank)):
        line("time", **time_norm_bwd(
            gen, f"rmsnorm_bwd DeepSeek-V2 {what}",
            f"({LM_PROMPT},{dim}) bf16, w fp32, {dim // 8} vectors a row",
            LM_PROMPT, dim, 1, False, DEEPSEEK.norm_eps, DEEPSEEK_NORM_STD))
    line("time", **time_norm_bwd(
        gen, "rmsnorm_bwd Qwen2-VL block norms",
        f"2 x ({rows},{VL.d_model}) bf16, w fp32, {VL.d_model // 8} vectors "
        "a row: one training layer's ln1 and ln2", rows, VL.d_model, 2,
        False, VL.norm_eps, 0.1), launches_a_step=2 * VL_TRAIN.n_layers + 1)

    zamba_norm_rec = dict(
        time_norm_bwd(
            gen, "rmsnorm_bwd Zamba2-7B out_norm",
            f"({rows},{ZAMBA_TRAIN.d_inner}) bf16, w fp32, "
            f"{ZAMBA_TRAIN.d_inner // 8} vectors a row, two warps a row: one "
            "Mamba block's gated out_norm", rows, ZAMBA_TRAIN.d_inner, 1,
            False, ZAMBA_TRAIN.norm_eps, ZAMBA_NORM_STD),
        route="cuda", source="src/repro_torch/csrc/rmsnorm_bwd.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:17",
        launches=paths["zamba_train"]["rmsnorm_bwd"],
        launches_a_step=ZAMBA_TRAIN_MAMBA, max_abs_err=errs["rmsnorm_bwd"])
    line("time", **zamba_norm_rec)

    Bz, S = LM_TRAIN_RUNS[1][1:3]
    t, extra, variant, bms, by = time_ssd_bwd(gen, LM, host=True)
    ssd_rec = dict(
        name="ssd_bwd", route="cuda", source="src/repro_torch/csrc/ssd_bwd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:31",
        launches=launches["ssd_bwd"], max_abs_err=errs["ssd_bwd"],
        bound_ms=bms, bound_by=by, variant=variant,
        shape=f"x, dy ({Bz},{S},64,64) bf16, B/C ({Bz},{S},1,128) bf16, "
              "chunk 256: one Mamba2 layer's scan backward", **t)
    line("time", **ssd_rec, **extra)
    t, extra, variant, bms, by = time_ssd_bwd(gen, ZAMBA_TRAIN)
    H, N = ZAMBA_TRAIN.ssm_nheads, ZAMBA_TRAIN.ssm_state
    zamba_ssd_rec = dict(
        name="ssd_bwd Zamba2-7B", route="cuda",
        source="src/repro_torch/csrc/ssd_bwd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:31",
        launches=paths["zamba_train"]["ssd_bwd"],
        launches_a_step=ZAMBA_TRAIN_MAMBA, max_abs_err=errs["ssd_bwd"],
        bound_ms=bms, bound_by=by, bound_share=bms / t["ms"],
        variant=variant, simt_ms=extra.pop("simt_ms"),
        shape=f"x, dy ({Bz},{S},{H},64) bf16, B/C ({Bz},{S},1,{N}) bf16, "
              "chunk 256: one Zamba2-7B training layer's scan backward", **t)
    line("time", **zamba_ssd_rec, **extra)
    cmdr = time_flash_bwd_lm(gen, CMDR_TRAIN, "Command-R")
    line("time", **cmdr, launches_a_step=CMDR_TRAIN.n_layers,
         launches=paths["cmdr_train"]["flash_attention_bwd"])
    wg_rec = _kernel_record(cmdr, "src/repro_torch/csrc/flash_attention_bwd.cu",
                            "src/repro/models/attention.py:168",
                            launches["flash_bwd_wg"],
                            errs["flash_attention_bwd_wg"], keep=WG_KEYS,
                            name="flash_attention_bwd, Hopper streaming form")
    # the backward at Zamba2-7B's shared block (2 x 2048) and HuBERT
    # X-Large's encoder (4 x 1000 frames, non-causal), the Hopper form on
    # its D = 128 kernels
    layer_recs = [
        _kernel_record(time_flash_bwd_lm(gen, ZAMBA_TRAIN,
                                         "Zamba2-7B shared block"),
                       "src/repro_torch/csrc/flash_attention_bwd.cu",
                       "src/repro/models/attention.py:168",
                       paths["zamba_train"]["flash_attention_bwd"],
                       errs["flash_bwd_case"][ZAMBA_FLASH_BWD_CASE],
                       launches_a_step=ZAMBA_TRAIN.n_layers
                       - ZAMBA_TRAIN_MAMBA),
        _kernel_record(time_flash_bwd_lm(gen, HUBERT, "HuBERT X-Large",
                                         causal=False, B=HUBERT_BATCH,
                                         S=HUBERT_FRAMES),
                       "src/repro_torch/csrc/flash_attention_bwd.cu",
                       "src/repro/models/attention.py:168",
                       paths["hubert_run"]["flash_attention_bwd"],
                       errs["flash_bwd_case"][HUBERT_FLASH_BWD_CASE],
                       launches_a_step=HUBERT.n_layers)]
    for rec in layer_recs:
        line("time", **rec)
    return [norm_rec, ssd_rec, zamba_norm_rec, zamba_ssd_rec, wg_rec] \
        + layer_recs


def time_ssd_bwd(gen, cfg, host=False) -> tuple:
    """The scan's backward at one of ``cfg``'s training layers, x and dy
    (2,2048,H,P) bf16, B and C (2,2048,G,N), its chunk: ``ms`` of the
    variant the wrapper picks beside its plain version (no one PyTorch call
    computes it) and, apart, the "simt" kernels' time, the time without
    the card's lead, the wrapper's host time and, with ``host``, its split
    into parts. Returns (times, extra, variant, bound ms, bound by)."""
    Bz, S = LM_TRAIN_RUNS[1][1:3]
    shape = (Bz, S, cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state,
             cfg.ssm_ngroups)
    args = ssd_inputs(gen, *shape, torch.bfloat16, False)[:6]
    dy = _randn(gen, args[0].shape, torch.bfloat16)

    def bwd():
        return ssd_bwd(*args, cfg.ssm_chunk, dy)

    def ssd_counts():
        return ssd.bwd_launches, ssd.bwd_tc_launches
    n_all, n_fast = ssd_counts()
    t = {"ms": time_ms(bwd, reps=10)}
    variant = _bwd_variant(ssd_counts, n_fast, n_all, "tc")
    t.update(plain_ms=time_ms(lambda: ssd_bwd_ref(*args, cfg.ssm_chunk, dy),
                              reps=3),
             library_ms=None)                 # no one PyTorch call does it
    Q = min(cfg.ssm_chunk, S)
    extra = {"simt_ms": time_ms(lambda: ssd_launch_bwd(
                 *args, Q, dy, None, None, "simt"), reps=5),
             "ms_no_lead": time_ms(bwd, reps=10, lead=False),
             "host_us": host_us(bwd, reps=10)}
    if host:
        extra["host"] = ssd_bwd_host(args, dy, Q)
    return (t, extra, variant) + bound_ms(*ssd_bwd_work(*shape,
                                                        cfg.ssm_chunk, 2))


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
    dry = start_dryrun()
    try:
        return run(dry)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()


def run(dry) -> int:
    phase("1 build", phase_build)
    errs = phase("2 kernels", phase_kernels)
    trace, cfg, venv = agent_env()
    launches = Counter(phase("3 agent serving", phase_serve, venv))
    launches.update(phase("4 Mamba2 serving", phase_lm))
    launches.update(phase("4b agent training", phase_train, trace, cfg, venv))
    launches.update(phase("4c TinyLlama serving", phase_dense))
    launches.update(phase("4d Qwen2-MoE serving", phase_moe))
    launches.update(phase("4e Gemma-3 serving", phase_gemma))
    launches.update(phase("4f DeepSeek-V2 serving", phase_deepseek))
    launches.update(phase("4g Qwen1.5-4B serving", phase_qwen4b))
    paths = {"zamba": phase("4h Zamba2-7B serving", phase_zamba),
             "cmdr": phase("4i Command-R serving", phase_cmdr),
             "vl": phase("4j Qwen2-VL serving", phase_vl)}
    for counts in paths.values():
        launches.update(counts)
    policies, grid = phase("6 grid", phase_grid)
    service = phase("7 service", phase_service, policies)
    del policies
    torch.cuda.empty_cache()
    lm_train, runs = phase("8 LM training", phase_lm_train)
    paths.update(runs)
    examples = phase("8b examples", phase_examples)
    distributed = phase("8c remat and --distributed",
                        phase_remat_distributed)
    phase("8d dry run", phase_dryrun, dry)
    for counts in (grid, service, lm_train, examples, distributed):
        launches.update(counts)
    records = phase("5 timing", phase_timing, errs, launches, paths)
    print(json.dumps({"kernels": records}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
