"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B].

24L, d_model=2048, 16H (kv=16), 60 routed experts top-4 + 4 shared,
expert d_ff=1408, vocab 151936, QKV bias.

The port's full config runs the flash-attention kernel
(``attn_impl="flash"``) where the reference's runs ``"reference"``: a
prefill is causal, unwindowed, has no ``kv_len_valid`` and a head dim of
128 over as many kv heads as q heads, the case the reference's
``attention_core`` sends to its flash kernel when asked; both settings
compute the same function there (decode takes the reference math either
way). ``SMOKE`` keeps the reference's ``"reference"``.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151_936,
    qkv_bias=True,
    n_experts=60,
    top_k=4,
    n_shared_experts=4,
    expert_d_ff=1408,
    shared_d_ff=1408,
    rope_theta=1_000_000.0,
    mlp_activation="silu",
    attn_impl="flash",
)
SMOKE = CONFIG.reduced()
