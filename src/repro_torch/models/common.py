"""Model configuration and shared helpers (port of ``repro.models.common``).

Every assigned architecture (and the Mirage agent's own foundation model)
is described by a single ``ModelConfig``. The config is a *logical*
description; sharding-driven padding (vocab, heads) is applied by
``padded()`` so the published numbers stay visible in ``configs/``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch

DEFAULT_VOCAB_MULTIPLE = 128

# the config's dtype strings, as the reference's jnp.dtype() reads them
_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity -----------------------------------------------------------
    arch_id: str = "unnamed"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    # trunk --------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 2
    n_kv_heads: int = 2
    head_dim: int = 0            # 0 -> d_model // n_heads
    d_ff: int = 256
    vocab_size: int = 256
    # attention ----------------------------------------------------------
    causal: bool = True
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    sliding_window: int = 0          # 0 -> full attention
    local_global_period: int = 0     # e.g. 6 -> 5 local + 1 global per group
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0    # gemma3: different theta for local layers
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) half-dims
    use_rope: bool = True
    # mlp ----------------------------------------------------------------
    mlp_activation: str = "silu"     # silu | gelu
    gated_mlp: bool = True
    parallel_block: bool = False     # command-r style attn || ffn
    mlp_bias: bool = False
    # norm ---------------------------------------------------------------
    norm_style: str = "rms"          # rms | layer
    norm_eps: float = 1e-6
    gemma_norm: bool = False         # (1 + w) RMS scaling
    sandwich_norm: bool = False      # extra post-block norms (gemma3)
    embed_scale: bool = False        # multiply embeddings by sqrt(d_model)
    final_logit_softcap: float = 0.0
    tie_embeddings: bool = False
    # MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    shared_d_ff: int = 0
    first_k_dense: int = 0           # leading dense layers before MoE starts
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    moe_scheme: str = "topk"         # topk (one-hot dispatch) | sorted
    moe_group_size: int = 4096       # GShard capacity groups: dispatch
                                     # tensor bytes scale with S^2/G, so long
                                     # prefills route in G-token groups
    # MLA (deepseek-v2) ----------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # SSM (mamba2) ---------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    attn_every: int = 0              # hybrid: a (shared) attn block every N layers
    shared_attn: bool = False        # zamba2: attention block weights are tied
    # modality -------------------------------------------------------------
    is_encoder: bool = False         # hubert: bidirectional, no decode
    embed_inputs: bool = True        # False -> inputs are precomputed embeddings
    # numerics / execution ---------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_impl: str = "reference"     # reference | chunked | flash
    attn_chunk: int = 1024           # kv-chunk for the chunked impl
    remat: bool = True
    remat_save_outputs: bool = False  # save per-block psum'd outputs (skips
                                      # recomputing TP all-reduces in bwd)
    scan_layers: bool = True
    # sharding-driven padding (filled by padded()) ----------------------------
    padded_vocab: int = 0
    padded_heads: int = 0
    padded_kv_heads: int = 0

    # ----------------------------------------------------------------- api
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def nq(self) -> int:
        return self.padded_heads or self.n_heads

    @property
    def nkv(self) -> int:
        return self.padded_kv_heads or self.n_kv_heads

    @property
    def vocab(self) -> int:
        return self.padded_vocab or self.vocab_size

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def cdtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.param_dtype]

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence handling (SSM / hybrid-with-tiny-attn)."""
        return self.family in ("ssm", "hybrid")

    @property
    def supports_decode(self) -> bool:
        return not self.is_encoder

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def padded(self, model_axis: int, vocab_multiple: int = DEFAULT_VOCAB_MULTIPLE) -> "ModelConfig":
        """Apply sharding-driven padding for a given model-parallel axis size.

        * vocab is padded up to lcm(vocab_multiple, model_axis) boundaries
          (Megatron-style; extra logits are masked at the loss).
        * q-heads are padded to a multiple of `model_axis` with
          zero-initialised extra heads (function preserving).
        * kv-heads are left as-is; the sharder replicates them when they do
          not divide the axis.
        """
        vmult = int(math.lcm(vocab_multiple, model_axis))
        pv = _round_up(self.vocab_size, vmult)
        ph = self.n_heads
        if self.n_heads % model_axis != 0:
            ph = _round_up(self.n_heads, model_axis)
        # kv heads are NEVER padded: the attention head-map gather keeps
        # real heads exact while padded q heads borrow the last kv head —
        # avoids +60% KV-cache storage on MHA archs (qwen1.5-4b).
        return self.replace(padded_vocab=pv, padded_heads=ph,
                            padded_kv_heads=self.n_kv_heads)

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 4 if self.attn_every or self.local_global_period else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            param_dtype="float32",
            compute_dtype="float32",
            attn_impl="reference",
            padded_vocab=0,
            padded_heads=0,
            padded_kv_heads=0,
        )
        if self.local_global_period:
            kw["local_global_period"] = 2
            kw["n_layers"] = 4
        if self.n_experts:
            kw.update(n_experts=8, top_k=2, expert_d_ff=64,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      shared_d_ff=64, first_k_dense=min(self.first_k_dense, 1))
        if self.use_mla:
            kw.update(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16, head_dim=0)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16, d_model=64)
        if self.attn_every:
            kw.update(attn_every=self.attn_every and 3, n_layers=7)
        if self.mrope_sections:
            kw["mrope_sections"] = (4, 2, 2)
        return self.replace(**kw)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ----------------------------------------------------------------------------
# Layer plan: heterogeneous layer stacking for scan-over-layers.
# ----------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Segment:
    """``n_repeat`` scanned repetitions of a sub-pattern of block kinds.

    Each position in ``pattern`` owns its own parameter tree stacked over
    ``n_repeat`` (unless the kind is marked shared, in which case a single
    tied tree is used as a closure).
    """
    n_repeat: int
    pattern: Tuple[str, ...]            # e.g. ("local",)*5 + ("global",)
    shared: Tuple[bool, ...] = ()       # per-position weight tying

    def __post_init__(self):
        if not self.shared:
            object.__setattr__(self, "shared", (False,) * len(self.pattern))


def layer_plan(cfg: ModelConfig) -> Tuple[Segment, ...]:
    """Derive the layer plan for an architecture from its config."""
    L = cfg.n_layers
    if cfg.family in ("ssm",):
        return (Segment(L, ("mamba",)),)
    if cfg.family == "hybrid" and cfg.attn_every:
        p = cfg.attn_every
        groups, rem = divmod(L, p)
        segs = []
        if groups:
            segs.append(Segment(groups, ("mamba",) * (p - 1) + ("attn",),
                                shared=(False,) * (p - 1) + (cfg.shared_attn,)))
        if rem:
            segs.append(Segment(1, ("mamba",) * rem))
        return tuple(segs)
    if cfg.local_global_period:
        p = cfg.local_global_period
        groups, rem = divmod(L, p)
        segs = []
        if groups:
            segs.append(Segment(groups, ("local",) * (p - 1) + ("global",)))
        if rem:
            segs.append(Segment(1, ("local",) * rem))
        return tuple(segs)
    if cfg.n_experts:
        segs = []
        fk = cfg.first_k_dense
        if fk:
            segs.append(Segment(fk, ("dense",)))
        segs.append(Segment(L - fk, ("moe",)))
        return tuple(segs)
    return (Segment(L, ("dense",)),)


def n_block_applications(cfg: ModelConfig) -> int:
    return sum(s.n_repeat * len(s.pattern) for s in layer_plan(cfg))
