"""Pass driver: walk a source tree, run every pass, apply suppressions,
and gate against the committed baseline.

The baseline (``repro_torch/analysis/static_baseline.json``) maps finding
fingerprints (pass id + path + message — line-free, so unrelated edits
don't churn it) to grandfathered counts. A fresh run fails only on
findings *in excess* of the baseline; baseline entries no longer
observed are reported as stale so the file can shrink toward empty
(``python -m repro_torch.analysis --update-baseline`` rewrites it).
"""
from __future__ import annotations

import ast
import collections
import json
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

from .base import Finding, Pass, apply_suppressions
from .dtypes import DtypeDisciplinePass
from .imports import ImportDisciplinePass
from .loops import LaneLoopPass
from .purity import JitPurityPass

#: the package the gate covers by default, and its committed baseline
PACKAGE_ROOT = pathlib.Path(__file__).resolve().parent.parent
BASELINE = pathlib.Path(__file__).resolve().parent / "static_baseline.json"


def all_passes() -> List[Pass]:
    """One fresh instance of every registered pass, stable order."""
    return [ImportDisciplinePass(), JitPurityPass(), LaneLoopPass(),
            DtypeDisciplinePass()]


def analyze_source(src: str, relpath: str,
                   passes: Optional[Sequence[Pass]] = None,
                   suppress: bool = True) -> List[Finding]:
    """Run ``passes`` over one source string (suppressions applied)."""
    passes = list(passes) if passes is not None else all_passes()
    tree = ast.parse(src, filename=relpath)
    findings: List[Finding] = []
    for p in passes:
        if p.applies(relpath):
            findings.extend(p.run(tree, src, relpath))
    findings.sort(key=lambda f: (f.path, f.line, f.pass_id))
    return apply_suppressions(findings, src) if suppress else findings


def analyze_tree(root: pathlib.Path,
                 passes: Optional[Sequence[Pass]] = None) -> List[Finding]:
    """Run the suite over every ``*.py`` under ``root`` (a package dir,
    e.g. ``src/repro_torch``). Paths in findings are relative to
    ``root``'s parent, so they read ``repro_torch/...`` regardless of the
    checkout."""
    root = root.resolve()
    findings: List[Finding] = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(root.parent).as_posix()
        src = path.read_text()
        findings.extend(analyze_source(src, rel, passes))
    return findings


# ----------------------------------------------------------------- baseline
def load_baseline(path: pathlib.Path) -> Dict[str, int]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    return {str(k): int(v) for k, v in data.get("findings", {}).items()}


def save_baseline(findings: Sequence[Finding], path: pathlib.Path) -> None:
    counts = collections.Counter(f.fingerprint for f in findings)
    payload = {
        "_comment": ("grandfathered static-analysis findings of "
                     "src/repro_torch; regenerate with python -m "
                     "repro_torch.analysis --update-baseline, and shrink "
                     "toward empty (ROADMAP)"),
        "version": 1,
        "findings": {k: counts[k] for k in sorted(counts)},
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")


def diff_baseline(findings: Sequence[Finding], baseline: Dict[str, int]
                  ) -> Tuple[List[Finding], Dict[str, int]]:
    """-> (findings in excess of the baseline, stale baseline entries)."""
    budget = dict(baseline)
    fresh: List[Finding] = []
    for f in findings:
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
        else:
            fresh.append(f)
    stale = {k: v for k, v in budget.items() if v > 0}
    return fresh, stale
