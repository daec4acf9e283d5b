"""Mamba2 1.3B [arXiv:2405.21060; hf:state-spaces/mamba2-1.3b].

48L attention-free SSD blocks, d_model=2048 (d_inner=4096, 64 heads of
headdim 64), ssm_state=128, conv width 4, vocab=50280 (padded to 50304 for
the 16-way model axis).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=1,            # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_conv_width=4,
    ssm_chunk=256,
    use_rope=False,
)
SMOKE = CONFIG.reduced()
