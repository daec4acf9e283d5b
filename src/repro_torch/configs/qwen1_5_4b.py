"""Qwen1.5 4B [hf:Qwen/Qwen1.5-4B].

40L, d_model=2560, 20H MHA (kv=20), d_ff=6912, vocab=151936, QKV bias.
20 heads do not divide the 16-way model axis; the sharder pads q/kv heads
to 32 with zeroed weights (function preserving; see DESIGN §4).

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
    arch_id="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=5_000_000.0,
    mlp_activation="silu",
    attn_impl="flash",
)
SMOKE = CONFIG.reduced()
