"""Training substrate: the train, prefill and serve step factories,
gradient compression, chained sub-jobs, fault handling, AdamW and
checkpointing.

Submodules are imported lazily (PEP 562), as the reference's are, so
light consumers — e.g. ``repro_torch.core``'s RL stack, which needs only
``repro_torch.train.optimizer`` and ``repro_torch.train.step`` — don't
eagerly pull in the checkpoint/chain machinery at import time.
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "ChainConfig": "chain",
    "ChainedTrainer": "chain",
    "AsyncCheckpointer": "checkpoint",
    "latest_step": "checkpoint",
    "restore_checkpoint": "checkpoint",
    "save_checkpoint": "checkpoint",
    "ElasticPlan": "fault",
    "PreemptionGuard": "fault",
    "StragglerMonitor": "fault",
    "make_error_feedback_transform": "grad_compression",
    "OptimizerConfig": "optimizer",
    "adamw_update": "optimizer",
    "global_norm": "optimizer",
    "init_opt_state": "optimizer",
    "lr_schedule": "optimizer",
    "make_prefill_step": "step",
    "make_serve_step": "step",
    "make_train_step": "step",
    "value_and_grad": "step",
}

__all__ = sorted(_EXPORTS)

if TYPE_CHECKING:  # pragma: no cover - static analysis only
    from .chain import ChainConfig, ChainedTrainer  # noqa: F401
    from .checkpoint import (AsyncCheckpointer, latest_step,  # noqa: F401
                             restore_checkpoint, save_checkpoint)
    from .fault import (ElasticPlan, PreemptionGuard,  # noqa: F401
                        StragglerMonitor)
    from .grad_compression import make_error_feedback_transform  # noqa: F401
    from .optimizer import (OptimizerConfig, adamw_update,  # noqa: F401
                            global_norm, init_opt_state, lr_schedule)
    from .step import (make_prefill_step, make_serve_step,  # noqa: F401
                       make_train_step, value_and_grad)


def __getattr__(name: str):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
