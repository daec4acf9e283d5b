"""HuBERT X-Large [arXiv:2106.07447].

48L encoder-only (bidirectional), d_model=1280, 16H MHA, d_ff=5120,
vocab=504 (k-means target units). The conv waveform frontend is a stub per
the assignment: ``input_specs`` provides precomputed frame embeddings
(B, T, d_model). Masked-unit prediction objective. Positional information
via rotary (adaptation of the conv-relative positional embedding; DESIGN
§2.3). Encoder-only => no decode shapes.

The port's full config runs the flash-attention kernel
(``attn_impl="flash"``) where the reference's runs ``"reference"``, at its
16 heads of 1280/16 = 80 (the kernel's Hopper form, on its D = 128
instantiation with the columns past 80 read as zeros): the encoder is
non-causal and unwindowed, and neither training nor a forward passes
``kv_len_valid``, the case the reference's ``attention_core`` sends to its
flash kernel when asked, and both settings compute the same function there.
``SMOKE`` keeps the reference's ``"reference"``.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    is_encoder=True,
    embed_inputs=False,
    norm_style="layer",
    norm_eps=1e-5,
    gated_mlp=False,
    mlp_activation="gelu",
    attn_impl="flash",
)
SMOKE = CONFIG.reduced()
