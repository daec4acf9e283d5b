"""Kernel scopes: named regions of plain PyTorch that a hand-written kernel
computes in one launch, the counterpart of the reference's
``jax.named_scope("pallas_...")`` markers. ``roofline.analysis.count_step``
counts the bytes the ops inside a scope move as ``kernel_fusable_bytes``:
a fused kernel keeps them on chip. Outside a count a scope costs a list
append and pop."""
from __future__ import annotations

import contextlib
import threading

# the reference's two KERNEL_SCOPES: flash attention's chunked scan and the
# SSD scan's intra-chunk part
KERNEL_SCOPES = ("flash_attention", "ssd")

_state = threading.local()


def active():
    """The innermost active scope's name, or None."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def kernel_scope(name: str):
    if name not in KERNEL_SCOPES:
        raise ValueError(f"unknown kernel scope {name!r}")
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(name)
    try:
        yield
    finally:
        stack.pop()
