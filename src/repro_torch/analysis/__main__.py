"""Static invariant gate of the port: run the ``repro_torch.analysis``
passes over ``src/repro_torch`` and fail on any finding not covered by
the committed baseline.

  import-discipline   optional-dependency policy, PEP 562 lazy inits, no
                      jax/repro import, no kernel build at import
  jit-purity          no host effects in autograd, remat and local_map
                      bodies or the counterparts of the reference's jitted
                      and scanned functions
  lane-loop           no Python loops over the batch axis in hot modules
  dtype-discipline    explicit dtypes; no float64 in the model path;
                      torch allocations there state dtype and device

Usage:
  PYTHONPATH=src python -m repro_torch.analysis                 # all passes
  PYTHONPATH=src python -m repro_torch.analysis lane-loop ...   # subset
  PYTHONPATH=src python -m repro_torch.analysis --update-baseline

Exit status: 0 clean modulo the baseline, 1 on a non-baselined finding,
2 on a usage error. ``--update-baseline`` rewrites
``repro_torch/analysis/static_baseline.json`` from the fresh run (commit
the diff; the file should only ever shrink).
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from repro_torch.analysis import runner


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("passes", nargs="*",
                    help="subset of pass ids to run (default: all)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the committed baseline from this run")
    ap.add_argument("--baseline", type=pathlib.Path, default=runner.BASELINE)
    ap.add_argument("--root", type=pathlib.Path, default=runner.PACKAGE_ROOT,
                    help="package directory to analyze")
    args = ap.parse_args(argv)      # exits 2 on a usage error

    passes = runner.all_passes()
    known = {p.pass_id for p in passes}
    if args.passes:
        unknown = set(args.passes) - known
        if unknown:
            print(f"repro_torch.analysis: unknown pass id(s) "
                  f"{sorted(unknown)}; known: {sorted(known)}")
            return 2
        passes = [p for p in passes if p.pass_id in args.passes]

    findings = runner.analyze_tree(args.root, passes)

    if args.update_baseline:
        # a partial-pass run must not drop other passes' baseline entries
        if set(p.pass_id for p in passes) != known:
            print("repro_torch.analysis: --update-baseline requires running "
                  "all passes")
            return 2
        runner.save_baseline(findings, args.baseline)
        print(f"repro_torch.analysis: baseline updated ({len(findings)} "
              f"grandfathered finding(s)) -> {args.baseline}")
        return 0

    baseline = runner.load_baseline(args.baseline)
    if args.passes:     # only gate the selected passes against the baseline
        prefix = tuple(f"{p}::" for p in args.passes)
        baseline = {k: v for k, v in baseline.items() if k.startswith(prefix)}
    fresh, stale = runner.diff_baseline(findings, baseline)

    counts = {}
    for f in findings:
        counts[f.pass_id] = counts.get(f.pass_id, 0) + 1
    ran = ", ".join(f"{p.pass_id}={counts.get(p.pass_id, 0)}" for p in passes)
    print(f"repro_torch.analysis: {len(findings)} finding(s) over "
          f"{args.root} ({ran}); baseline covers {len(findings) - len(fresh)}")

    if stale:
        print(f"repro_torch.analysis: {sum(stale.values())} stale baseline "
              "entr(ies) — shrink the baseline with --update-baseline:")
        for k in sorted(stale):
            print(f"  [stale x{stale[k]}] {k}")
    if fresh:
        print(f"repro_torch.analysis: FAILED — {len(fresh)} non-baselined "
              "finding(s):")
        for f in fresh:
            print(f"  {f}")
        print("fix the violation, suppress it inline with a justification "
              "(# repro-static: ok[pass-id] ...), or — for acknowledged "
              "debt — rerun with --update-baseline and commit the diff")
        return 1
    print("repro_torch.analysis: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
