"""The agent trunk's model layers, ported from ``repro.models`` (serving
subset: dense blocks in forward mode). Parameters carry a leading expert
axis E (E=1 for a single trunk), so every projection is one grouped GEMM."""
from .common import ModelConfig, Segment, layer_plan  # noqa: F401
