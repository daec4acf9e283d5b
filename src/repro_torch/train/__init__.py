"""Training substrate, ported so far for serving: the prefill and serve
step factories and the preemption guard."""
from .fault import PreemptionGuard  # noqa: F401
from .step import make_prefill_step, make_serve_step  # noqa: F401
