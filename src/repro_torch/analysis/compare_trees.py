"""Phases of ``chip_smoke.py`` from two trees of the repo, run in turns on
one card, to compare the trees within one machine.

    python -m repro_torch.analysis.compare_trees --parent build/parent \\
        --change build/archive [--runs serving|backward] [--out chiprun_out/cmp]

On the card only. Each tree is a checkout of one commit (``git archive``
unpacked). Each run is a fresh process in that tree's root that imports
the tree's own ``chip_smoke.py`` (which puts the tree's ``src/`` first on
the path), builds its kernels (a tree's first run compiles them into its
own ``build/``), then runs what ``--runs`` names. ``serving`` (the
default): the phases below that the tree's script has,

* ``4``: Mamba2-1.3B serving (``[lm_serve]``: prefill ms, decode ms a step);
* ``4c``: TinyLlama-1.1B serving (``[dense_serve]``);
* ``6`` then ``7``: the Fig-8 grid and the service (``[service]``: the solo
  and co-sim tenants' decisions a second).

``backward``: phase 5's timing of the backward kernels at the trunk's
shapes (``time_backward``: ``[time]`` lines, each kernel's ms by name; the
flash backward's and the GEMM backward's at one layer, and whatever else
the tree's script times there).

The runs go parent, change, change, parent, so a drift of the machine over
the call shows as a spread within each tree. Each run's whole log goes to
``<out>/<tree>.<n>.log``; the script prints one ``[compare]`` JSON line a
run with the numbers above and each phase's wall time, and exits non-zero
if a run failed.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HEAD = """
import sys
sys.path.insert(0, ".")
import chip_smoke as c
c.phase("1 build", c.phase_build)
"""
RUNS = {
    "serving": HEAD + """
if hasattr(c, "phase_lm"):
    c.phase("4 Mamba2 serving", c.phase_lm)
if hasattr(c, "phase_dense"):
    c.phase("4c TinyLlama serving", c.phase_dense)
policies, _ = c.phase("6 grid", c.phase_grid)
c.phase("7 service", c.phase_service, policies)
""",
    "backward": HEAD + """
from collections import defaultdict
import torch
gen = torch.Generator(device="cuda").manual_seed(1)
c.phase("5 backward timing", c.time_backward, gen, defaultdict(float),
        defaultdict(int))
""",
}

ORDER = ("parent", "change", "change", "parent")


def summarize(log: str) -> dict:
    """The numbers of one run's log that the comparison reads."""
    out = {"phase_s": {}}
    for raw in log.splitlines():
        if not raw.startswith("[") or "] {" not in raw:
            continue
        tag, body = raw[1:].split("] ", 1)
        try:
            rec = json.loads(body)
        except ValueError:
            continue
        if tag == "phase":
            out["phase_s"][rec["name"]] = rec["wall_s"]
        elif tag in ("lm_serve", "dense_serve"):
            out[tag] = {k: rec[k] for k in ("prefill_ms", "decode_ms_mean",
                                            "decode_ms_p50") if k in rec}
        elif tag == "service" and "decisions_per_s" in rec \
                and "tenants" in rec:
            out[f"service {rec['what']}"] = rec["decisions_per_s"]
        elif tag == "time" and "ms" in rec:
            out[f"time {rec['name']}"] = rec["ms"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--change", required=True, type=Path)
    ap.add_argument("--runs", choices=sorted(RUNS), default="serving")
    ap.add_argument("--out", default=Path("chiprun_out/cmp"), type=Path)
    args = ap.parse_args(argv)
    args.out.mkdir(parents=True, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    trees = {"parent": args.parent.resolve(), "change": args.change.resolve()}
    rc = 0
    for n, name in enumerate(ORDER):
        res = subprocess.run([sys.executable, "-c", RUNS[args.runs]],
                             cwd=trees[name],
                             env=env, capture_output=True, text=True)
        log = res.stdout + res.stderr
        (args.out / f"{name}.{n}.log").write_text(log)
        print("[compare] " + json.dumps({"run": n, "tree": name,
                                         "rc": res.returncode,
                                         **summarize(res.stdout)}),
              flush=True)
        rc = rc or res.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
