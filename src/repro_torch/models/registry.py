"""Architecture registry (port of ``repro.models.registry``): ``--arch <id>``
resolution and the dry run's input shape cells.

The four assigned input-shape cells per LM architecture:

  train_4k     seq 4,096  global_batch 256   -> runs train_step
  prefill_32k  seq 32,768 global_batch 32    -> runs prefill
  decode_32k   seq 32,768 global_batch 128   -> runs serve_step (1 token)
  long_500k    seq 524,288 global_batch 1    -> runs serve_step (1 token)

Skips, the reference's: long_500k for full-attention archs, decode shapes
for encoder-only archs.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Tuple

import torch

from .common import ModelConfig

_ARCH_MODULES = {
    "command-r-35b": "repro_torch.configs.command_r_35b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "mirage-agent": "repro_torch.configs.mirage_agent",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "tinyllama-1.1b": "repro_torch.configs.tinyllama_1_1b",
    "zamba2-7b": "repro_torch.configs.zamba2_7b",
}

# the reference's order
ASSIGNED_ARCHS = ("deepseek-v2-236b", "qwen2-moe-a2.7b", "command-r-35b",
                  "tinyllama-1.1b", "qwen1.5-4b", "gemma3-27b", "mamba2-1.3b",
                  "qwen2-vl-7b", "zamba2-7b", "hubert-xlarge")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def list_archs() -> Tuple[str, ...]:
    return tuple(_ARCH_MODULES)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(_ARCH_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


def shape_spec(shape) -> ShapeSpec:
    """A cell's ``ShapeSpec``: ``shape`` names one of ``SHAPES`` or is a
    ``ShapeSpec`` (a smaller cell of a test)."""
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def cell_supported(cfg: ModelConfig, shape) -> Tuple[bool, str]:
    """Is (arch x shape) a runnable dry-run cell? Returns (ok, reason)."""
    spec = shape_spec(shape)
    if spec.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only: no autoregressive decode"
    if spec.name == "long_500k" and not cfg.supports_long_context:
        return False, ("full attention is quadratic at 500k "
                       "(skip per assignment)")
    return True, ""


def runnable_cells():
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = cell_supported(cfg, shape)
            yield arch, shape, ok, why


def input_specs(cfg: ModelConfig, shape, dtype=torch.int32) -> Dict:
    """Meta-device stand-ins (shapes and dtypes, no data) for every model
    input of a cell, the reference's ``ShapeDtypeStruct``s; a decode
    cell's cache is ``transformer.init_cache`` in bf16 on the meta
    device."""
    spec = shape_spec(shape)
    B, S = spec.global_batch, spec.seq_len

    def sds(shape_, dt):
        return torch.empty(shape_, dtype=dt, device="meta")

    def pos_struct(b, s):
        if cfg.mrope_sections:
            return sds((3, b, s), torch.int32)
        return sds((b, s), torch.int32)

    if spec.kind in ("train", "prefill"):
        if not cfg.embed_inputs:   # audio: precomputed frame embeddings
            out = {"inputs": sds((B, S, cfg.d_model), torch.bfloat16)}
        else:
            out = {"inputs": sds((B, S), torch.int32)}
        if spec.kind == "train":
            out["labels"] = sds((B, S), torch.int32)
        out["positions"] = pos_struct(B, S)
        return out
    # decode: one new token against an S-token cache
    from . import transformer
    cache = transformer.init_cache(cfg, B, S, dtype=torch.bfloat16,
                                   device="meta")
    return {"token": sds((B, 1), torch.int32),
            "positions": pos_struct(B, 1),
            "cache": cache,
            "index": sds((), torch.int32)}
