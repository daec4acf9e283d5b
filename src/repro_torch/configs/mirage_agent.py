"""The paper's own model: the Mirage provisioner foundation transformer.

§4.6 / Fig. 5: a small transformer over the 144-snapshot state matrix (40
state variables per snapshot + 1 ordinal action variable), with dual V/P
heads. The MoE variant (§4.7 / Fig. 6) wraps E=10 expert transformers under
a dense softmax gate (Eq. 7). These configs describe the *trunk*; heads
live in repro_torch.core.foundation.

The port's trunk runs the flash-attention kernel (``attn_impl="flash"``)
where the reference's agent uses ``"reference"``: for this non-causal,
unwindowed case the reference's ``attention_core`` computes the same
function either way, and the parity tests hold the port's flash path
against the reference's ``"reference"`` path.
"""
from repro_torch.models.common import ModelConfig

# tuned defaults standing in for the paper's RayTune result (Fig. 5)
CONFIG = ModelConfig(
    arch_id="mirage-agent",
    family="dense",
    n_layers=4,
    d_model=256,
    n_heads=8,
    n_kv_heads=8,
    d_ff=1024,
    vocab_size=2,          # unused: inputs are state vectors, not tokens
    causal=False,
    is_encoder=True,
    embed_inputs=False,
    use_rope=False,
    gated_mlp=False,
    mlp_activation="gelu",
    norm_style="layer",
    attn_impl="flash",
    remat=False,
    scan_layers=False,
)
SMOKE = CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                       d_ff=128)

# MoE foundation model: E experts, dense (Eq. 7) gating
N_EXPERTS = 10
