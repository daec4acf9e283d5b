"""Training substrate: the train, prefill and serve step factories,
gradient compression, chained sub-jobs, fault handling, AdamW and
checkpointing."""
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
