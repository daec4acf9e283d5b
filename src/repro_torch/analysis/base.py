"""Shared machinery of the static-analysis suite: findings, the Pass
protocol, the suppression comment syntax, and the committed baseline.

The reference's suite (``repro.analysis``) read in PyTorch's terms over
``src/repro_torch``. Every pass is an AST visitor over one parsed source
file. Findings are identified by a line-free fingerprint (pass id + path +
message), so the committed baseline survives unrelated edits that shift
line numbers; the baseline stores a count per fingerprint and only
*excess* findings fail the gate (see ``repro_torch.analysis.runner``).

Suppression syntax (the reference's, so a suppression reads the same in
both packages):

* line-level — a trailing comment on the flagged statement's first line::

      for b, s in enumerate(sims):   # repro-static: ok[lane-loop] why...

* file-level — a comment anywhere in the file::

      # repro-static: skip-file[jit-purity] why...

``ok[*]`` / ``skip-file[*]`` suppress every pass. A justification after
the closing bracket is encouraged (and conventional) but not parsed.
"""
from __future__ import annotations

import ast
import dataclasses
import re
import sys
from typing import Dict, List, Optional, Sequence, Set, Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*repro-static:\s*(ok|skip-file)\[([\w*,-]+)\]")

#: module roots importable unconditionally at module level anywhere in
#: src/repro_torch (the port's hard dependencies, plus the package itself
#: and the stdlib)
HARD_DEPS = frozenset({"numpy", "torch", "repro_torch"})

#: module roots the port never imports, anywhere: JAX and the reference
#: package (the port keeps its own copy of what it needs)
FORBIDDEN_ROOTS = frozenset({"jax", "jaxlib", "repro"})


def stdlib_roots() -> frozenset:
    return frozenset(sys.stdlib_module_names)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""
    pass_id: str
    path: str          # repo-relative posix path
    line: int
    message: str

    @property
    def fingerprint(self) -> str:
        """Line-free identity used for baseline matching."""
        return f"{self.pass_id}::{self.path}::{self.message}"

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.pass_id}] {self.message}"


class Pass:
    """Base class: one invariant, one AST walk.

    ``pass_id`` names the rule (and the suppression/baseline key);
    ``applies(relpath)`` scopes it to the module set whose contract it
    enforces; ``run`` returns raw findings (suppressions and the
    baseline are applied by the runner).
    """

    pass_id: str = ""
    description: str = ""

    def applies(self, relpath: str) -> bool:
        return True

    def run(self, tree: ast.Module, src: str, relpath: str) -> List[Finding]:
        raise NotImplementedError

    def finding(self, relpath: str, node: ast.AST, message: str) -> Finding:
        return Finding(self.pass_id, relpath, getattr(node, "lineno", 0),
                       message)


def parse_suppressions(src: str) -> Tuple[Set[str], Dict[int, Set[str]]]:
    """-> (file-level suppressed pass ids, line -> suppressed pass ids).

    ``'*'`` in a set means "every pass".
    """
    file_level: Set[str] = set()
    by_line: Dict[int, Set[str]] = {}
    for lineno, line in enumerate(src.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        kind, ids = m.group(1), {p.strip() for p in m.group(2).split(",")}
        if kind == "skip-file":
            file_level |= ids
        else:
            by_line.setdefault(lineno, set()).update(ids)
    return file_level, by_line


def apply_suppressions(findings: Sequence[Finding], src: str
                       ) -> List[Finding]:
    file_level, by_line = parse_suppressions(src)
    if not file_level and not by_line:
        return list(findings)

    def suppressed(f: Finding) -> bool:
        if file_level & {f.pass_id, "*"}:
            return True
        at_line = by_line.get(f.line, set())
        return bool(at_line & {f.pass_id, "*"})

    return [f for f in findings if not suppressed(f)]


# ---------------------------------------------------------------- AST utils
def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` expression -> "a.b.c"; None for anything fancier."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def module_aliases(tree: ast.Module, module: str) -> Set[str]:
    """Local names bound to the top-level module ``module`` by
    ``import module`` / ``import module as m``."""
    aliases: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    aliases.add(a.asname or module)
    return aliases


def numpy_aliases(tree: ast.Module) -> Set[str]:
    """Local names bound to the host ``numpy`` module (``np`` etc.)."""
    return module_aliases(tree, "numpy")


def torch_aliases(tree: ast.Module) -> Set[str]:
    """Local names bound to the ``torch`` module."""
    return module_aliases(tree, "torch")


def call_kwarg_names(node: ast.Call) -> Set[str]:
    return {kw.arg for kw in node.keywords if kw.arg is not None}


def has_kwargs_splat(node: ast.Call) -> bool:
    """``f(..., **kw)``: any keyword may arrive through the splat."""
    return any(kw.arg is None for kw in node.keywords)
