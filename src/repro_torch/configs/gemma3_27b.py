"""Gemma-3 27B [hf:google/gemma-3-27b-pt].

62L, d_model=5376, 32H GQA kv=16, head_dim=128, d_ff=21504, vocab=262144.
5:1 local(1024-window):global attention interleave, QK-norm, gemma-style
(1+w) RMSNorm with sandwich (pre+post) norms, sqrt(d) embedding scale,
different rope theta for local (10k) vs global (1M) layers, tied embeddings.

The port's full config runs the flash-attention kernel
(``attn_impl="flash"``) where the reference's runs ``"reference"``. A
prefill then sends a global layer to the kernel causal and unwindowed, as
the reference's ``attention_core`` does when asked, and a local layer to
the kernel with its window mask, where the reference's takes its chunked
scan: the same function (decode takes the reference math either way).
``SMOKE`` keeps the reference's ``"reference"``.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    qk_norm=True,
    sliding_window=1024,
    local_global_period=6,    # 5 local + 1 global
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    gemma_norm=True,
    sandwich_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    mlp_activation="gelu",
    attn_impl="flash",
)
SMOKE = CONFIG.reduced()
