"""Qwen2-VL 7B [arXiv:2409.12191; hf:Qwen/Qwen2-VL-7B].

28L LM backbone, d_model=3584, 28H GQA kv=4, d_ff=18944, vocab=152064,
M-RoPE with (t,h,w) sections (16,24,24) over head_dim=128, QKV bias. The
vision encoder is a stub, as in the reference: precomputed patch
embeddings (``vision_embeds``) are merged at the image tokens
(``vision_mask``) by ``transformer.embed_inputs``.

The port's full config runs the flash-attention kernel
(``attn_impl="flash"``), as its other GQA LMs do, at 28 q heads over 4 kv
heads of 128 (a group of 7). ``SMOKE`` keeps the reference's
``"reference"``. With image positions the two settings compute different
functions, in both packages: ``"reference"`` masks by the temporal
stream, under which an image's patches share one position and see each
other both ways; ``"flash"`` masks by sequence index.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152_064,
    qkv_bias=True,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    mlp_activation="silu",
    attn_impl="flash",
)
SMOKE = CONFIG.reduced()
