"""``import-discipline`` — the optional-dependency policy as a machine
check, the reference's rule over the port's hard dependencies:

* no unconditional module-level import outside the stdlib and the hard
  dependencies (numpy, torch, repro_torch itself). Optional packages
  (msgpack, zstandard, triton, scipy, einops) must sit behind
  ``try/except ImportError`` with a fallback, or inside a function
  (deferred to use time);
* heavy aggregate ``__init__``\\ s (``repro_torch.train``,
  ``repro_torch.analysis``, ``repro_torch.serve``) must export lazily via
  PEP 562: a module-level ``__getattr__`` and no eager relative import
  outside ``TYPE_CHECKING``.

Two rules are the port's own, checked in the same pass:

* no import of ``jax``, ``jaxlib`` or ``repro`` (the reference package)
  anywhere in the tree — inside a function, behind ``try`` or under
  ``TYPE_CHECKING`` too, and through ``importlib.import_module`` /
  ``__import__`` with a literal name;
* no module-level call that builds or loads a kernel (``_build.build`` /
  ``_build.load``, ``ctypes.CDLL``, ``torch.utils.cpp_extension.load``,
  ``triton.compile``): kernels are built at first use, never at import,
  so every module imports on a machine without nvcc or a card.
"""
from __future__ import annotations

import ast
from typing import List, Set

from .base import (FORBIDDEN_ROOTS, HARD_DEPS, Finding, Pass, dotted_name,
                   stdlib_roots)

#: package __init__s that promise PEP 562 lazy exports. Relative-posix
#: paths under src/.
LAZY_INITS = (
    "repro_torch/train/__init__.py",
    "repro_torch/analysis/__init__.py",
    "repro_torch/serve/__init__.py",
)

#: calls that compile or load a kernel library, whatever the module
_BUILD_CALLS = {
    "ctypes.CDLL", "ctypes.PyDLL", "ctypes.cdll.LoadLibrary",
    "torch.utils.cpp_extension.load", "torch.utils.cpp_extension.load_inline",
    "cpp_extension.load", "cpp_extension.load_inline", "triton.compile",
}
#: the port's own builder (``repro_torch.kernels._build``) and its entries
_BUILD_MODULE = "_build"
_BUILD_FUNCS = {"build", "load"}
_DYNAMIC_IMPORTS = {"importlib.import_module", "__import__"}


def _is_type_checking_if(node: ast.If) -> bool:
    t = node.test
    return (isinstance(t, ast.Name) and t.id == "TYPE_CHECKING") or (
        isinstance(t, ast.Attribute) and t.attr == "TYPE_CHECKING")


def _catches_import_error(handler: ast.ExceptHandler) -> bool:
    def names(t):
        if t is None:
            return ["<bare>"]
        if isinstance(t, ast.Tuple):
            return [n for e in t.elts for n in names(e)]
        if isinstance(t, ast.Name):
            return [t.id]
        if isinstance(t, ast.Attribute):
            return [t.attr]
        return []
    ok = {"ImportError", "ModuleNotFoundError", "Exception", "<bare>"}
    return bool(set(names(handler.type)) & ok)


def _build_names(tree: ast.Module):
    """-> (names bound to the ``_build`` module, names bound to its
    ``build``/``load``)."""
    mods: Set[str] = set()
    funcs: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[-1] == _BUILD_MODULE and a.asname:
                    mods.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            from_build = (node.module or "").split(".")[-1] == _BUILD_MODULE
            for a in node.names:
                if from_build and a.name in _BUILD_FUNCS:
                    funcs.add(a.asname or a.name)
                elif a.name == _BUILD_MODULE:
                    mods.add(a.asname or a.name)
    return mods, funcs


def _import_time_nodes(body):
    """Every node that runs when the module is imported: module-level
    statements, class bodies, and a def's decorators and defaults, but not
    the body of a def or a lambda."""
    stack = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            stack.extend(node.decorator_list)
            stack.extend(node.args.defaults)
            stack.extend(d for d in node.args.kw_defaults if d is not None)
            continue
        if isinstance(node, ast.Lambda):
            stack.extend(node.args.defaults)
            stack.extend(d for d in node.args.kw_defaults if d is not None)
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class ImportDisciplinePass(Pass):
    pass_id = "import-discipline"
    description = ("module-level imports restricted to stdlib + hard deps; "
                   "optional packages behind try/except ImportError; "
                   "lazy __init__s stay PEP 562; no jax/repro import; no "
                   "kernel build at import")

    def run(self, tree: ast.Module, src: str, relpath: str) -> List[Finding]:
        findings: List[Finding] = []
        allowed = stdlib_roots() | HARD_DEPS
        lazy_init = relpath in LAZY_INITS

        def visit_body(body, guarded: bool) -> None:
            for node in body:
                if isinstance(node, ast.Try):
                    g = guarded or any(_catches_import_error(h)
                                       for h in node.handlers)
                    visit_body(node.body, g)
                    visit_body(node.orelse, guarded)
                    visit_body(node.finalbody, guarded)
                    for h in node.handlers:
                        visit_body(h.body, guarded)
                elif isinstance(node, ast.If):
                    if _is_type_checking_if(node):
                        continue       # static-analysis only, never executed
                    visit_body(node.body, guarded)
                    visit_body(node.orelse, guarded)
                elif isinstance(node, (ast.With,)):
                    visit_body(node.body, guarded)
                elif isinstance(node, ast.Import):
                    for a in node.names:
                        self._check_root(findings, relpath, node,
                                         a.name.split(".")[0], allowed,
                                         guarded)
                elif isinstance(node, ast.ImportFrom):
                    if node.level:
                        if lazy_init:
                            findings.append(self.finding(
                                relpath, node,
                                "eager relative import in a PEP 562 lazy "
                                "__init__ (move under TYPE_CHECKING or "
                                "export via __getattr__)"))
                        continue
                    root = (node.module or "").split(".")[0]
                    self._check_root(findings, relpath, node, root, allowed,
                                     guarded)

        visit_body(tree.body, guarded=False)

        if lazy_init:
            has_getattr = any(
                isinstance(n, ast.FunctionDef) and n.name == "__getattr__"
                for n in tree.body)
            if not has_getattr:
                findings.append(Finding(
                    self.pass_id, relpath, 1,
                    "lazy __init__ lost its module-level __getattr__ "
                    "(PEP 562 export contract)"))
        findings.extend(self._forbidden(tree, relpath))
        findings.extend(self._import_time_builds(tree, relpath))
        return findings

    def _check_root(self, findings, relpath, node, root, allowed, guarded
                    ) -> None:
        if root in allowed or root in FORBIDDEN_ROOTS or guarded or not root:
            return
        findings.append(self.finding(
            relpath, node,
            f"unconditional module-level import of optional package "
            f"'{root}' (wrap in try/except ImportError with a fallback, "
            f"or defer to use time)"))

    def _forbidden(self, tree: ast.Module, relpath: str) -> List[Finding]:
        """Imports of JAX or the reference package, wherever they stand."""
        findings: List[Finding] = []
        for node in ast.walk(tree):
            roots = []
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                roots = [(node.module or "").split(".")[0]]
            elif isinstance(node, ast.Call) and \
                    dotted_name(node.func) in _DYNAMIC_IMPORTS and \
                    node.args and isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                roots = [node.args[0].value.split(".")[0]]
            for root in roots:
                if root in FORBIDDEN_ROOTS:
                    findings.append(self.finding(
                        relpath, node,
                        f"import of '{root}' in the port (it imports "
                        "neither JAX nor the reference package; keep a "
                        "copy of what it needs)"))
        return findings

    def _import_time_builds(self, tree: ast.Module, relpath: str
                            ) -> List[Finding]:
        mods, funcs = _build_names(tree)
        findings: List[Finding] = []
        for node in _import_time_nodes(tree.body):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            parts = name.split(".")
            if name in _BUILD_CALLS or name in funcs or (
                    len(parts) == 2 and parts[0] in mods
                    and parts[1] in _BUILD_FUNCS):
                findings.append(self.finding(
                    relpath, node,
                    f"kernel build or load {name}() at import time (build "
                    "at first use: every module imports without nvcc or "
                    "a card)"))
        return findings
