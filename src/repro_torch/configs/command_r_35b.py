"""Cohere Command-R 35B [hf:CohereForAI/c4ai-command-r-v01].

40L, d_model=8192, 64H GQA kv=8, d_ff=22528, vocab=256000, no biases,
parallel attention/FFN block, LayerNorm, tied embeddings.

The port's full config runs the flash-attention kernel
(``attn_impl="flash"``) where the reference's runs ``"reference"``: a
prefill is causal, unwindowed, has no ``kv_len_valid`` and a head dim of
128 over 8 kv heads, the case the reference's ``attention_core`` sends to
its flash kernel when asked; both settings compute the same function
there (decode takes the reference math either way). ``SMOKE`` keeps the
reference's ``"reference"``.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256_000,
    parallel_block=True,
    norm_style="layer",
    norm_eps=1e-5,
    tie_embeddings=True,
    rope_theta=8_000_000.0,
    mlp_activation="silu",
    attn_impl="flash",
)
SMOKE = CONFIG.reduced()
