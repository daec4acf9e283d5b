"""Training substrate: the prefill and serve step factories, the
preemption guard, AdamW and checkpointing."""
from .checkpoint import (AsyncCheckpointer, latest_step,  # noqa: F401
                         restore_checkpoint, save_checkpoint)
from .fault import PreemptionGuard  # noqa: F401
from .optimizer import (OptimizerConfig, adamw_update,  # noqa: F401
                        global_norm, init_opt_state, lr_schedule)
from .step import make_prefill_step, make_serve_step  # noqa: F401
