"""Slurm-like cluster simulator and trace synthesis (numpy; verbatim
copies of ``repro.sim``'s modules, minus co-tenancy)."""
from .cluster import Cluster  # noqa: F401
from .faults import (FAULT_PROFILES, FaultPlan, FaultSpec,  # noqa: F401
                     get_fault_spec)
from .scenarios import (CHAIN_SHAPES, LOAD_LEVELS, SCENARIOS,  # noqa: F401
                        Scenario, get_scenario, iter_scenarios, make_env,
                        make_vector_env)
from .timeline import BackgroundTimeline  # noqa: F401
from .simulator import (SampleBatch, SlurmSimulator, replay,  # noqa: F401
                        sample_batch, step_batch)
from .trace import (PROFILES, ClusterProfile, Job, clean_trace,  # noqa: F401
                    split_trace, synthesize_trace, trace_stats)
from .workload import SubJobChain, pair_outcome, run_pair  # noqa: F401
