"""Mirage core, ported: the provisioning environments and the self-healing
control plane (numpy copies of ``repro.core``), the foundation models, the
DQN and PG learners, offline pretraining, online training and the batched
evaluation loop."""
from .agent import (AGGRESSIVE_METHOD, ALL_METHODS,  # noqa: F401
                    DEFAULT_METHOD, RL_METHODS, EvalResult, LearnerPolicy,
                    build_policy, evaluate_batch, pretrain_foundation,
                    train_online_dqn, train_online_pg)
from .baselines import (AvgWaitPolicy, ReactivePolicy,  # noqa: F401
                        TreePolicy)
from .control import (ChainDriver, ChainLane, ChainResult,  # noqa: F401
                      CircuitBreaker, ControlPlane, DecisionJournal,
                      JournalCorruptionError, RetryExhaustedError,
                      RetryPolicy, TransientControlError)
from .dqn import DQNConfig, DQNLearner  # noqa: F401
from .foundation import FoundationConfig, init_foundation, q_values  # noqa: F401
from .pg import PGConfig, PGLearner  # noqa: F401
from .policy import (FallbackPolicy, Policy, batch_obs,  # noqa: F401
                     stack_obs)
from .provisioner import (EnvConfig, ProvisionEnv,  # noqa: F401
                          ReplayCheckpointCache, VectorProvisionEnv,
                          collect_offline_samples)
from .replay import ReplayBuffer  # noqa: F401
from .reward import RewardConfig, shape_reward  # noqa: F401
from .state import (STATE_DIM, StateHistory, StateHistoryBatch,  # noqa: F401
                    encode_sample_batch, encode_snapshot, encode_snapshots,
                    summary_features, summary_features_batch)
