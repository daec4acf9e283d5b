"""First-class evaluation scenarios: the §6 grid as a registry.

The paper's headline results (Figs. 8-10) come from an evaluation matrix
— methods x clusters x load levels x chain shapes. This module names
every cell: a ``Scenario`` is (ClusterProfile, load level, chain shape,
optional fault profile), registered under ``"<cluster>/<load>/<chain>"``
(e.g. ``V100/heavy/single``) for the fault-free grid and
``"<cluster>/<load>/<chain>/<fault>"`` (e.g. ``V100/heavy/single/faulty``)
for the faulted variants, iterable for sweeps via ``iter_scenarios``.
The Fig-8/9 grid runner (benchmarks.bench_interruption), the examples,
and ad-hoc experiments all draw their environments from here instead of
re-declaring private cluster/load dicts.

Faulted cells are deterministic: the cell's ``FaultSpec`` profile plus
the trace horizon, cluster size and the run's seed fully determine the
``FaultPlan`` every simulator in the cell consumes (see
``repro.sim.faults``), so faulted results are reproducible cell-by-cell.

Environment construction imports ``repro.core`` lazily, so this module
stays importable from ``repro.sim`` without a package cycle.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Iterable, Iterator, List, Optional, Union

from .faults import FAULT_PROFILES, FaultPlan, FaultSpec
from .trace import PROFILES, ClusterProfile, Job, synthesize_trace

# offered-load regimes reproducing the paper's queue-wait bands (§3.1):
# node-hours demanded / capacity
LOAD_LEVELS: Dict[str, float] = {"light": 0.45, "medium": 0.8, "heavy": 1.05}

# chained sub-job shapes: Fig. 8 single-node pairs, Fig. 9 8-node pairs
CHAIN_SHAPES: Dict[str, int] = {"single": 1, "multi": 8}

# canonical co-simulation tenant count registered as "<cell>/co8" cells;
# arbitrary counts resolve through get_scenario("<cell>/co<N>")
CO_TENANTS = 8


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named cell of the evaluation grid."""
    name: str
    profile: ClusterProfile
    load: str
    load_scale: float
    chain: str
    chain_nodes: int
    fault: str = ""                      # fault profile name; "" = none
    fault_spec: Optional[FaultSpec] = None
    tenants: int = 1                     # co-sim tenant count; 1 = solo

    @property
    def cluster(self) -> str:
        return self.profile.name

    @property
    def _fault_suffix(self) -> str:
        return f"/{self.fault}" if self.fault else ""

    @property
    def _co_suffix(self) -> str:
        return f"/co{self.tenants}" if self.tenants > 1 else ""

    def with_chain_nodes(self, n_nodes: int) -> "Scenario":
        """This cell with an arbitrary chain size: the registered shape
        when one matches ``n_nodes``, else an ad-hoc ``<n>n`` variant
        (sweep runners accept chain sizes outside CHAIN_SHAPES)."""
        if n_nodes == self.chain_nodes:
            return self
        for cname, nodes in CHAIN_SHAPES.items():
            if nodes == n_nodes:
                return SCENARIOS[f"{self.cluster}/{self.load}/{cname}"
                                 f"{self._fault_suffix}"
                                 ].with_tenants(self.tenants)
        return dataclasses.replace(
            self, name=(f"{self.cluster}/{self.load}/{n_nodes}n"
                        f"{self._fault_suffix}{self._co_suffix}"),
            chain=f"{n_nodes}n", chain_nodes=n_nodes)

    def with_tenants(self, tenants: int) -> "Scenario":
        """This cell with a co-simulation tenant count: the registered
        ``/co<N>`` cell when one exists (``CO_TENANTS``, or back to the
        solo cell at 1), else an ad-hoc variant — sweep and bench runners
        accept arbitrary counts (e.g. ``co1024``)."""
        if tenants == self.tenants:
            return self
        base = (self.name[:-len(self._co_suffix)] if self.tenants > 1
                else self.name)
        name = base if tenants <= 1 else f"{base}/co{tenants}"
        if name in SCENARIOS:
            return SCENARIOS[name]
        return dataclasses.replace(self, name=name, tenants=tenants)

    def make_trace(self, months: Optional[int] = None, seed: int = 0
                   ) -> List[Job]:
        return synthesize_trace(self.profile, months=months, seed=seed,
                                load_scale=self.load_scale)

    def make_fault_plan(self, trace: List[Job], seed: int = 0
                        ) -> Optional[FaultPlan]:
        """The cell's deterministic FaultPlan over the trace horizon
        (None for fault-free cells). Same (spec, trace, seed) -> same
        plan, so faulted cells replay identically run-to-run."""
        if self.fault_spec is None:
            return None
        horizon = trace[-1].submit_time + 3 * 24 * 3600.0
        return self.fault_spec.make_plan(horizon, self.profile.n_nodes,
                                         seed)

    def env_config(self, history: int = 144, interval: float = 600.0,
                   **kw):
        from repro_torch.core import EnvConfig
        return EnvConfig(n_nodes=self.profile.n_nodes, history=history,
                         interval=interval, chain_nodes=self.chain_nodes,
                         **kw)

    def make_env(self, months: Optional[int] = None, seed: int = 0,
                 history: int = 144, interval: float = 600.0, cache=None,
                 trace: Optional[List[Job]] = None):
        """A scalar ProvisionEnv for this scenario (trace seeded ``seed``)."""
        trace = trace if trace is not None else self.make_trace(months, seed)
        cfg = self.env_config(history, interval,
                              faults=self.make_fault_plan(trace, seed))
        return make_env(trace, cfg, seed=seed, cache=cache)

    def make_vector_env(self, batch: int, months: Optional[int] = None,
                        seed: int = 0, history: int = 144,
                        interval: float = 600.0, cache=None,
                        trace: Optional[List[Job]] = None):
        """A B-lane VectorProvisionEnv for this scenario; pass ``cache=``
        to share one ReplayCheckpointCache across sweep cells that reuse
        the same trace (the cache must carry the same fault plan)."""
        trace = trace if trace is not None else self.make_trace(months, seed)
        cfg = self.env_config(history, interval,
                              faults=self.make_fault_plan(trace, seed))
        return make_vector_env(trace, cfg, batch, seed=seed, cache=cache)

    def make_co_vector_env(self, groups: int,
                           tenants: Optional[int] = None,
                           months: Optional[int] = None, seed: int = 0,
                           history: int = 144, interval: float = 600.0,
                           cache=None, trace: Optional[List[Job]] = None):
        """A (groups x tenants)-lane CoTenantVectorEnv for this scenario:
        each group is one shared simulator in which the cell's tenant
        count of chains contend (``tenants`` overrides the cell's
        count for ad-hoc sweeps)."""
        trace = trace if trace is not None else self.make_trace(months, seed)
        cfg = self.env_config(history, interval,
                              faults=self.make_fault_plan(trace, seed))
        return make_co_vector_env(trace, cfg, groups,
                                  self.tenants if tenants is None
                                  else tenants, seed=seed, cache=cache)


def make_env(trace: List[Job], cfg, *, seed: int = 0, cache=None,
             **overrides):
    """THE constructor for scalar provisioning environments.

    Every call site builds its ``ProvisionEnv`` here (or through
    ``Scenario.make_env``, which delegates): the factory owns cache
    attachment and keyword overrides (``**overrides`` are applied to
    ``cfg`` via ``dataclasses.replace``), so experiment scripts stop
    re-plumbing constructor arguments. Imports ``repro.core`` lazily to
    keep ``repro.sim`` cycle-free."""
    from repro_torch.core import ProvisionEnv
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return ProvisionEnv(trace, cfg, seed=seed, cache=cache)


def make_vector_env(trace: List[Job], cfg, batch: int, *, seed: int = 0,
                    cache=None, **overrides):
    """THE constructor for vectorized provisioning environments.

    Like ``make_env`` but returns a B-lane ``VectorProvisionEnv``; lane
    ``i`` is bit-identical to ``make_env(trace, cfg, seed=seed + i)``.
    Pass ``cache=`` to share one ``ReplayCheckpointCache`` (and its
    immutable ``BackgroundTimeline``) across envs over the same trace;
    without it the env builds and owns one. ``differential=False`` in
    ``overrides`` forces the classic fork-per-lane reset path. For a
    different batch size over the same wiring use
    ``VectorProvisionEnv.resized(n)`` on the result."""
    from repro_torch.core import VectorProvisionEnv
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return VectorProvisionEnv(trace, cfg, batch, seed=seed, cache=cache)


def make_co_vector_env(trace: List[Job], cfg, groups: int, tenants: int,
                       *, seed: int = 0, cache=None, **overrides):
    """THE constructor for co-tenant vectorized environments.

    Like ``make_vector_env`` but returns a ``CoTenantVectorEnv`` whose
    ``groups * tenants`` lanes are grouped into ``groups`` shared
    simulators of ``tenants`` contending chains each. With
    ``tenants=1`` group ``g`` is bit-identical to lane ``g`` of
    ``make_vector_env(trace, cfg, groups, seed=seed)`` (test-pinned).
    Pass ``cache=`` to share one ``ReplayCheckpointCache`` across envs
    over the same trace."""
    from repro_torch.core.cotenant import CoTenantVectorEnv
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return CoTenantVectorEnv(trace, cfg, groups, tenants, seed=seed,
                             cache=cache)


def _build_registry() -> Dict[str, Scenario]:
    reg = {}
    for prof in PROFILES.values():
        for lname, scale in LOAD_LEVELS.items():
            for cname, nodes in CHAIN_SHAPES.items():
                s = Scenario(f"{prof.name}/{lname}/{cname}", prof, lname,
                             scale, cname, nodes)
                reg[s.name] = s
                for fname, spec in FAULT_PROFILES.items():
                    f = Scenario(f"{s.name}/{fname}", prof, lname, scale,
                                 cname, nodes, fault=fname, fault_spec=spec)
                    reg[f.name] = f
    # every cell gets a canonical co-simulation variant: same trace and
    # fault plan, CO_TENANTS chains contending in one shared simulator
    for s in list(reg.values()):
        co = dataclasses.replace(s, name=f"{s.name}/co{CO_TENANTS}",
                                 tenants=CO_TENANTS)
        reg[co.name] = co
    return reg


SCENARIOS: Dict[str, Scenario] = _build_registry()


def _chain_name(chain: Union[str, int]) -> str:
    if isinstance(chain, str):
        return chain
    for name, nodes in CHAIN_SHAPES.items():
        if nodes == int(chain):
            return name
    raise KeyError(f"no chain shape with {chain} nodes "
                   f"(registered: {CHAIN_SHAPES})")


def get_scenario(cluster: str, load: Optional[str] = None,
                 chain: Union[str, int] = "single",
                 fault: str = "", tenants: int = 1) -> Scenario:
    """Look up a scenario by full name (``"V100/heavy/single"``,
    ``"V100/heavy/single/faulty"``, ``"V100/heavy/single/co8"``) or by
    (cluster, load, chain, fault, tenants) components; ``chain``
    accepts a shape name or a registered node count, ``fault`` a
    registered fault profile name ("" = fault-free). A trailing
    ``/co<N>`` selects the N-tenant co-simulation variant for *any* N
    (registered for ``co8``; ad-hoc, e.g. ``co1024``, otherwise)."""
    if load is None:
        name = cluster
        if name not in SCENARIOS:
            m = re.fullmatch(r"(.+)/co(\d+)", name)
            if m is not None:
                return SCENARIOS[m.group(1)].with_tenants(int(m.group(2)))
        return SCENARIOS[name]
    suffix = f"/{fault}" if fault else ""
    base = SCENARIOS[f"{cluster}/{load}/{_chain_name(chain)}{suffix}"]
    return base.with_tenants(tenants)


def iter_scenarios(clusters: Optional[Iterable[str]] = None,
                   loads: Optional[Iterable[str]] = None,
                   chains: Optional[Iterable[Union[str, int]]] = None,
                   faults: Optional[Iterable[str]] = None,
                   tenants: Optional[Iterable[int]] = (1,)
                   ) -> Iterator[Scenario]:
    """Iterate the grid in registry order, optionally filtered by cluster
    names, load-level names, chain shapes (names or node counts), and
    fault profile names (``""`` selects the fault-free cells; the default
    ``None`` — like the other filters — selects everything). Unlike the
    other filters, ``tenants`` defaults to ``(1,)`` — sweeps written
    against the solo grid keep their cell set; pass ``None`` (or an
    explicit count list) to include the ``/co<N>`` cells."""
    chain_names = None if chains is None else {_chain_name(c)
                                               for c in chains}
    fault_names = None if faults is None else set(faults)
    tenant_counts = None if tenants is None else set(tenants)
    for s in SCENARIOS.values():
        if clusters is not None and s.cluster not in clusters:
            continue
        if loads is not None and s.load not in loads:
            continue
        if chain_names is not None and s.chain not in chain_names:
            continue
        if fault_names is not None and s.fault not in fault_names:
            continue
        if tenant_counts is not None and s.tenants not in tenant_counts:
            continue
        yield s
