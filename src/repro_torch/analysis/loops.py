"""``lane-loop`` — vectorization-contract guard for the batched hot path.

The contracts say the vector-env observation pipeline is "one numpy pass
per lockstep interval": in the designated hot modules, Python
``for``-loops over the batch/lane axis are the regression this pass
catches (a per-lane loop reintroduced in ``encode_sample_batch`` would
silently give back the batched speedup while staying bit-identical). The
port keeps these modules as verbatim copies of the reference's, so the
pass and its lane vocabulary are the reference's, pointed at the copies.

Heuristic: a ``for`` statement in a hot module whose target/iterable
source mentions lane vocabulary (``sims``/``lanes``/``envs``/``batch``/
per-lane count arrays). Loops that are *part of the contract* (the
documented per-lane mean/std pair, CSR fill loops, dict-API adapters)
carry inline ``# repro-static: ok[lane-loop]`` suppressions with their
justification; everything else is either fixed or lives in the committed
baseline as acknowledged debt.
"""
from __future__ import annotations

import ast
import re
from typing import List

from .base import Finding, Pass

#: modules where vectorization over lanes is the contract
HOT_MODULES = (
    "repro_torch/sim/simulator.py",
    "repro_torch/sim/timeline.py",
    "repro_torch/sim/multitenant.py",
    "repro_torch/core/state.py",
    "repro_torch/core/policy.py",
    "repro_torch/core/provisioner.py",
)

_LANE_TOKENS = re.compile(
    r"\b(sims|lanes|envs|self\.envs|self\.batch|batch|n_lanes|"
    r"q_count|r_count|samples|preds|succs|live|wait_idx|sub_idx|active|"
    r"chunk)\b")


class LaneLoopPass(Pass):
    pass_id = "lane-loop"
    description = ("no Python for-loops over the batch/lane axis in the "
                   "vectorized hot modules (sample_batch, state encoder, "
                   "policy protocol, vector env)")

    def applies(self, relpath: str) -> bool:
        return relpath in HOT_MODULES

    def run(self, tree: ast.Module, src: str, relpath: str) -> List[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, (ast.For, ast.AsyncFor)):
                continue
            target = ast.get_source_segment(src, node.target) or ""
            it = ast.get_source_segment(src, node.iter) or ""
            seg = f"{target} in {it}"
            if _LANE_TOKENS.search(seg):
                findings.append(self.finding(
                    relpath, node,
                    f"Python for-loop over the lane/batch axis "
                    f"(`for {seg}`) in a vectorized hot module"))
        return findings
