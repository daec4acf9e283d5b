"""Zamba2 7B [arXiv:2411.15242; hf:Zyphra/Zamba2-7B].

81-layer hybrid: Mamba2 backbone (d_model=3584, d_inner=7168, headdim=64,
ssm_state=64) with a single weight-tied attention block (32H MHA + MLP
d_ff=14336) applied every 7th layer. vocab=32000.

Adaptation note (the reference's): upstream Zamba2 concatenates the
original embedding with the hidden state at shared-block inputs and uses
per-invocation LoRA deltas; the reference uses the standard residual
stream with fully tied shared-block weights (same parameter-sharing
topology, simpler dataflow), and so does the port.

The port's full config runs the flash-attention kernel
(``attn_impl="flash"``) where the reference's runs ``"reference"``, in the
shared block's 32 heads of 3584 / 32 = 112 (the kernel's Hopper form, on
its D = 128 instantiation with the columns past 112 read as zeros): a
prefill or a training pass there is causal, unwindowed and has no
``kv_len_valid``, the case the reference's ``attention_core`` sends to its
flash kernel when asked, and both settings compute the same function there
(decode takes the reference math either way). ``SMOKE`` keeps the
reference's ``"reference"``. Its Mamba blocks run the SSD scan (N = 64, 112
heads of 64, one group) and RMSNorm at d_model and at d_inner (the gated
``out_norm``).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv_width=4,
    ssm_chunk=256,
    attn_every=7,          # 6 mamba + 1 (shared) attn per group
    shared_attn=True,
    rope_theta=10_000.0,
    mlp_activation="gelu",
    attn_impl="flash",
)
SMOKE = CONFIG.reduced()
