"""Serving: the slot-based batched engine of the payload LM."""
from .engine import Request, ServeEngine  # noqa: F401
