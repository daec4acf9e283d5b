"""HuBERT X-Large [arXiv:2106.07447].

48L encoder-only (bidirectional), d_model=1280, 16H MHA, d_ff=5120,
vocab=504 (k-means target units). The conv waveform frontend is a stub per
the assignment: ``input_specs`` provides precomputed frame embeddings
(B, T, d_model). Masked-unit prediction objective. Positional information
via rotary (adaptation of the conv-relative positional embedding; DESIGN
§2.3). Encoder-only => no decode shapes.

The port keeps the reference's ``attn_impl="reference"``: the head dim,
1280/16 = 80, is not one the flash kernel takes (``HEAD_DIMS`` in
``kernels/flash_attention/ops.py``), so no kernel of the port runs on its
attention.
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
)
SMOKE = CONFIG.reduced()
