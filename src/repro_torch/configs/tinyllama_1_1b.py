"""TinyLlama 1.1B [arXiv:2401.02385; hf:TinyLlama/TinyLlama-1.1B].

22L, d_model=2048, 32H GQA kv=4, d_ff=5632, vocab=32000 (llama2 arch).

The port's full config runs the flash-attention kernel
(``attn_impl="flash"``) where the reference's runs ``"reference"``: a
prefill is causal, unwindowed and has no ``kv_len_valid``, the case the
reference's ``attention_core`` sends to its flash kernel when asked, and
both settings compute the same function there (decode takes the reference
math either way). ``SMOKE`` keeps the reference's ``"reference"``.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32_000,
    rope_theta=10_000.0,
    mlp_activation="silu",
    attn_impl="flash",
)
SMOKE = CONFIG.reduced()
