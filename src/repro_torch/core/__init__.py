"""Mirage core, ported: the provisioning environments (numpy copies of
``repro.core``), the foundation models, the DQN learner's serving surface
and the batched evaluation loop."""
from .agent import (ALL_METHODS, DEFAULT_METHOD, RL_METHODS,  # noqa: F401
                    EvalResult, LearnerPolicy, evaluate_batch)
from .baselines import (AvgWaitPolicy, ReactivePolicy,  # noqa: F401
                        TreePolicy)
from .dqn import DQNConfig, DQNLearner  # noqa: F401
from .foundation import FoundationConfig, init_foundation, q_values  # noqa: F401
from .policy import (FallbackPolicy, Policy, batch_obs,  # noqa: F401
                     stack_obs)
from .provisioner import (EnvConfig, ProvisionEnv,  # noqa: F401
                          ReplayCheckpointCache, VectorProvisionEnv,
                          collect_offline_samples)
from .reward import RewardConfig, shape_reward  # noqa: F401
from .state import (STATE_DIM, StateHistory, StateHistoryBatch,  # noqa: F401
                    encode_sample_batch, encode_snapshot, encode_snapshots,
                    summary_features, summary_features_batch)
