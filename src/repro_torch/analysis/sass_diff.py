"""The machine code of kernels from one CUDA source in two trees, side by
side, to tell a change of the code the card runs from a change of nothing.

    python -m repro_torch.analysis.sass_diff --parent build/parent \\
        --change . --source flash_attention_bwd \\
        --pair flash_bwd_tc_kernelILi32EE flash_bwd_tc_kernelILi32ELb0EE \\
        [--pair ...] [--out chiprun_out/sass]
    python -m repro_torch.analysis.sass_diff --parent build/parent \\
        --change . --source moe_gemm --all

Needs the CUDA toolkit (``nvcc``, ``cuobjdump``), not a card. Each tree's
``src/repro_torch/csrc/<source>.cu`` is compiled to a cubin with the flags
``kernels/_build.py`` builds the libraries with. A ``--pair`` names a
kernel in each tree by a piece of its mangled name (a template gaining an
argument changes the name); ``--all`` pairs every kernel of the parent's
source with the change's kernel of the same name (the anonymous
namespace's per-file tag aside) and lists the change's new kernels in a
``[sass-new]`` line. For each pair the script prints one
``[sass]`` JSON line: each side's registers, stack and spill bytes from
``-Xptxas=-v``, its instruction count, and how many instructions differ
once addresses, encodings, branch targets and the offsets of the kernel's
parameters in the constant bank are blanked (a new parameter moves those,
and nothing else). The normalised listings and their diff go to
``<out>/<pair>.{parent,change,diff}``.
"""
from __future__ import annotations

import argparse
import difflib
import json
import re
import subprocess
import sys
from pathlib import Path

from repro_torch.kernels import _build

_COMMENT = re.compile(r"/\*.*?\*/")
_PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")
_HEX = re.compile(r"\b0x[0-9a-f]+\b")
# opcodes whose hex operand is an address in the kernel
_JUMPS = ("BRA", "BSSY", "CALL", "JMP", "JMX", "BRX", "RET", "BREAK")


def normalise(sass: str) -> list:
    """The instructions of one kernel's ``cuobjdump -sass`` listing, one a
    line, with addresses, encodings, jump targets and parameter offsets
    blanked."""
    out = []
    for raw in sass.splitlines():
        ln = _COMMENT.sub("", raw).strip()
        if not ln or not ln.endswith(";"):
            continue
        ln = _PARAM.sub("c[0x0][param]", ln)
        op = ln.split()[1] if ln.startswith("@") else ln.split()[0]
        if op.split(".")[0] in _JUMPS:
            ln = _HEX.sub("addr", ln)
        out.append(" ".join(ln.split()))
    return out


def split_functions(dump: str) -> dict:
    """{mangled name: its listing} from ``cuobjdump -sass``'s output."""
    funcs, name = {}, None
    for raw in dump.splitlines():
        if raw.strip().startswith("Function :"):
            name = raw.split(":", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(raw)
    return {k: "\n".join(v) for k, v in funcs.items()}


def usage(ptxas_log: str) -> dict:
    """{mangled name: {"registers", "stack", "spill_stores",
    "spill_loads"}} from ``-Xptxas=-v``'s report."""
    out, name = {}, None
    for ln in ptxas_log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            out[name] = {}
        elif name is None:
            continue
        elif "bytes stack frame" in ln:
            n = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[name].update(stack=n[0], spill_stores=n[1], spill_loads=n[2])
        elif "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", ln).group(1))
    return out


_ANON = re.compile(r"(\d+)(?=_GLOBAL__N__)")


def _blank_anon(name: str) -> str:
    """``name`` with the anonymous namespace's mangled component (its
    length, then that many characters: the tag nvcc derives from the
    file's path, which differs between two trees) blanked."""
    m = _ANON.search(name)
    if m is None:
        return name
    return name[:m.start()] + "anon" + name[m.end() + int(m.group(1)):]


def same_name_pairs(parent, change) -> tuple:
    """[(parent name, change name)] of the kernels both trees have, by
    their names with the anonymous namespace's tag blanked, and the
    change's kernels the parent lacks."""
    def key(n):
        return _blank_anon(n)
    by_key = {key(n): n for n in change}
    pairs = [(n, by_key[key(n)]) for n in parent if key(n) in by_key]
    old = {key(n) for n in parent}
    return pairs, sorted(n for n in change if key(n) not in old)


def find(names, piece: str) -> str:
    hits = [n for n in names if piece in n]
    if len(hits) != 1:
        raise SystemExit(f"{piece!r} names {len(hits)} kernels, not 1")
    return hits[0]


def compile_tree(tree: Path, source: str, out: Path) -> tuple:
    """(usage, {name: listing}) of ``source`` in ``tree``."""
    cu = tree / "src" / "repro_torch" / "csrc" / f"{source}.cu"
    cubin = out / f"{tree.name}.{source}.cubin"
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                       "-fPIC")]
    res = subprocess.run([_build._nvcc(), *flags, "-cubin", "-o", str(cubin),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(res.stdout + res.stderr)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    return usage(res.stdout + res.stderr), split_functions(dump)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--change", required=True, type=Path)
    ap.add_argument("--source", required=True)
    ap.add_argument("--pair", nargs=2, action="append", default=[],
                    metavar=("PARENT_PIECE", "CHANGE_PIECE"))
    ap.add_argument("--all", action="store_true",
                    help="pair every kernel of the parent by its name")
    ap.add_argument("--out", default=Path("chiprun_out/sass"), type=Path)
    args = ap.parse_args(argv)
    if not args.pair and not args.all:
        ap.error("name a --pair or --all")
    args.out.mkdir(parents=True, exist_ok=True)
    sides = {"parent": compile_tree(args.parent.resolve(), args.source,
                                    args.out),
             "change": compile_tree(args.change.resolve(), args.source,
                                    args.out)}
    pairs = list(args.pair)
    if args.all:
        same, new = same_name_pairs(sides["parent"][1], sides["change"][1])
        pairs += same
        print("[sass-new] " + json.dumps({"source": args.source,
                                          "kernels": new}), flush=True)
    for i, pieces in enumerate(pairs):
        rec, code = {"pair": list(pieces)}, {}
        for (side, (use, funcs)), piece in zip(sides.items(), pieces):
            name = piece if piece in funcs else find(funcs, piece)
            code[side] = normalise(funcs[name])
            rec[side] = dict(use.get(name, {}), instructions=len(code[side]))
        stem = f"{args.source}.{i}" if args.all else pieces[1]
        for side in sides:
            (args.out / f"{stem}.{side}").write_text(
                "\n".join(code[side]) + "\n")
        diff = list(difflib.unified_diff(code["parent"], code["change"],
                                         "parent", "change", lineterm=""))
        (args.out / f"{stem}.diff").write_text("\n".join(diff) + "\n")
        rec["differing"] = sum(1 for ln in diff if ln[:1] in "+-"
                               and not ln.startswith(("+++", "---")))
        print("[sass] " + json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
