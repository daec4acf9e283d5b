"""Slurm-like cluster simulator, co-tenant simulation and trace synthesis
(numpy; verbatim copies of ``repro.sim``'s modules)."""
from .cluster import Cluster  # noqa: F401
from .faults import (FAULT_PROFILES, FaultPlan, FaultSpec,  # noqa: F401
                     get_fault_spec)
from .scenarios import (CHAIN_SHAPES, CO_TENANTS, LOAD_LEVELS,  # noqa: F401
                        SCENARIOS, Scenario, get_scenario, iter_scenarios,
                        make_co_vector_env, make_env, make_vector_env)
from .timeline import BackgroundTimeline  # noqa: F401
from .simulator import (SampleBatch, SlurmSimulator, replay,  # noqa: F401
                        sample_batch, step_batch)
from .multitenant import (MultiTenantSim, TenantOutcome,  # noqa: F401
                          make_tenant_chain, sample_tenant_batch)
from .trace import (PROFILES, ClusterProfile, Job, clean_trace,  # noqa: F401
                    split_trace, synthesize_trace, trace_stats)
from .workload import SubJobChain, pair_outcome, run_pair  # noqa: F401
