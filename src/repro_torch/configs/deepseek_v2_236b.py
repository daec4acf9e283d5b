"""DeepSeek-V2 236B [arXiv:2405.04434; hf deepseek-ai/DeepSeek-V2].

60L, d_model=5120, 128 heads with MLA (kv_lora=512, rope 64, nope/v 128),
160 routed experts top-6 + 2 shared, expert d_ff=1536, first layer dense
(d_ff 12288), vocab 102400.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=12288,              # dense (first_k_dense) layer width
    vocab_size=102_400,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    n_experts=160,
    top_k=6,
    n_shared_experts=2,
    expert_d_ff=1536,
    shared_d_ff=1536,
    first_k_dense=1,
    rope_theta=10_000.0,
    mlp_activation="silu",
)
SMOKE = CONFIG.reduced()
