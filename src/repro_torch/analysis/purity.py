"""``jit-purity`` — the reference's jit-boundary purity, read in PyTorch's
terms.

The port has no ``jax.jit``: what runs in its place are the bodies that
autograd runs, the bodies that remat runs twice, and the step functions
a CUDA graph or a compiler would capture. Host-side work there either
stalls the card (a copy to the host waits for every queued kernel),
breaks capture, or happens twice under remat. The pass marks:

* the ``forward``/``backward`` (and ``setup_context``/``jvp``/``vjp``)
  static methods of every ``torch.autograd.Function`` subclass;
* the function or lambda passed as the first argument of
  ``checkpoint(...)`` (remat) or ``local_map(...)`` — resolved to a
  ``def`` in the file, through a local assignment
  (``body = functools.partial(f, ...)``), or, where it is a parameter of
  the enclosing function, to what that function's callers in the file
  pass there;
* the ``TRACED`` table: the port's counterpart of each function the
  reference hands to ``jax.jit`` or ``lax.scan``. Where a ``lax.scan``
  became a Python loop, the entry names the loop's enclosing function;
* every def of the file that a marked body calls by name (``f(...)``,
  ``self.f(...)``), and so on: a helper runs inside its caller. Calls
  into other modules are not followed (each file is read alone).

Inside a marked body it flags the reference's three kinds of finding:

* host ``numpy`` calls (``np.*`` on the real numpy module; trace-time
  constants like ``np.dtype``/``np.finfo``/``np.prod`` are allowed);
* clock/randomness/IO host effects (``time.*``, ``random.*``,
  ``datetime.*``, ``print``, ``open``);
* Python-level mutation of enclosing state (``global``/``nonlocal``,
  writes to ``self.*`` or to an attribute or item of a non-local name,
  mutating method calls on non-local names). Autograd's ``ctx`` is a
  parameter, so ``ctx.save_for_backward`` and ``ctx.x = ...`` stay
  allowed;

and the torch reading of "host numpy": calls that copy a tensor to the
host or wait for the card (``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, and ``.synchronize()``, ``torch.cuda.synchronize`` among
them).
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .base import Finding, Pass, dotted_name, numpy_aliases

#: (port file, qualified name of the def, the reference's jit/scan site):
#: the port's counterpart of each function the reference traces. The
#: qualified name joins the enclosing classes and defs with ".". Paths of
#: the reference's sites are under src/.
TRACED = (
    # jax.jit(self._make_decode()): one decode step over every slot
    ("repro_torch/serve/engine.py", "ServeEngine._decode",
     "repro/serve/engine.py:46"),
    # jax.jit(make_train_step(...), donate_argnums=(0, 1))
    ("repro_torch/train/step.py", "make_train_step.train_step",
     "repro/train/chain.py:46"),
    # lax.scan over micro-batches: the port's loop in train_step
    ("repro_torch/train/step.py", "make_train_step.train_step",
     "repro/train/step.py:63"),
    ("repro_torch/train/step.py", "make_train_step.grad_fn",
     "repro/train/step.py:63"),
    ("repro_torch/train/step.py", "make_train_step.loss_for",
     "repro/train/step.py:63"),
    # jax.jit(fn).lower(): the dry run's train, prefill and serve steps
    ("repro_torch/train/step.py", "make_prefill_step.prefill_step",
     "repro/launch/dryrun.py:163"),
    ("repro_torch/train/step.py", "make_serve_step.serve_step",
     "repro/launch/dryrun.py:163"),
    # lax.scan over SSD chunks in ssd_chunked: the port hands the chunks
    # to the SSD kernel, whose plain version loops over them
    ("repro_torch/models/ssm.py", "_ssd_from_projections",
     "repro/models/ssm.py:140"),
    ("repro_torch/kernels/ssd/ops.py", "ssd_ref", "repro/models/ssm.py:140"),
    # lax.scan over kv chunks, forward and backward of the chunked flash
    ("repro_torch/models/attention.py", "_ChunkedFn.forward",
     "repro/models/attention.py:155"),
    ("repro_torch/models/attention.py", "_ChunkedFn.backward",
     "repro/models/attention.py:194"),
    # lax.scan over the latent chunks of MLA's prefill
    ("repro_torch/models/attention.py", "mla_latent_chunked",
     "repro/models/attention.py:507"),
    # lax.scan over a segment's repetitions (the cached modes' two scans)
    ("repro_torch/models/transformer.py", "apply_trunk",
     "repro/models/transformer.py:97"),
    ("repro_torch/models/transformer.py", "apply_trunk",
     "repro/models/transformer.py:126"),
    # the remat'd forward scan: its body
    ("repro_torch/models/transformer.py", "_forward_body",
     "repro/models/transformer.py:161"),
    # jax.jit(self._make_update()) and jax.jit(lambda p, s: q_values(...))
    ("repro_torch/core/dqn.py", "DQNLearner.loss", "repro/core/dqn.py:48"),
    ("repro_torch/core/foundation.py", "q_values", "repro/core/dqn.py:49"),
    # jax.jit(self._make_update()) and jax.jit(lambda: policy_logits(...))
    ("repro_torch/core/pg.py", "PGLearner.loss", "repro/core/pg.py:40"),
    ("repro_torch/core/foundation.py", "policy_logits",
     "repro/core/pg.py:41"),
    # @jax.jit step of the foundation's pretraining: its loss
    ("repro_torch/core/agent.py", "pretrain_foundation.loss_fn",
     "repro/core/agent.py:76"),
    # the kernels' jitted entries
    ("repro_torch/kernels/moe_gemm/ops.py", "moe_grouped_gemm",
     "repro/kernels/moe_gemm/ops.py:12"),
    ("repro_torch/kernels/moe_gemm/ops.py", "expert_mlp",
     "repro/kernels/moe_gemm/ops.py:17"),
    ("repro_torch/kernels/rmsnorm/ops.py", "rmsnorm",
     "repro/kernels/rmsnorm/ops.py:12"),
    ("repro_torch/kernels/flash_attention/ops.py", "flash_attention",
     "repro/kernels/flash_attention/ops.py:12"),
    ("repro_torch/kernels/ssd/ops.py", "ssd", "repro/kernels/ssd/ops.py:12"),
)

#: calls whose first positional argument runs as a traced body
_WRAP_CALLS = {
    "checkpoint", "torch.utils.checkpoint.checkpoint",
    "local_map", "torch.distributed.tensor.experimental.local_map",
}
_AUTOGRAD_BASES = {"torch.autograd.Function", "autograd.Function",
                   "Function"}
_AUTOGRAD_METHODS = {"forward", "backward", "setup_context", "jvp", "vjp"}
_PARTIAL = {"functools.partial", "partial"}

#: np.* attributes legitimate at trace time (static dtype/shape math)
_NP_TRACE_OK = {
    "dtype", "finfo", "iinfo", "result_type", "promote_types", "isscalar",
    "ndim", "shape", "prod", "broadcast_shapes", "issubdtype",
}

_HOST_MODULES = {"time", "random", "datetime"}
_MUTATORS = {"append", "extend", "insert", "remove", "clear", "update",
             "setdefault", "add", "pop", "popitem"}
#: tensor methods (and ``torch.cuda.synchronize``) that wait for the card
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_FUNCS = (ast.FunctionDef, ast.AsyncFunctionDef)
#: how many assignments or call sites a marked name is followed through
_MAX_DEPTH = 4


def _unwrap_partial(node: ast.AST) -> ast.AST:
    """partial(f, ...) -> f (for both decorator and call-site forms)."""
    if isinstance(node, ast.Call) and dotted_name(node.func) in _PARTIAL \
            and node.args:
        return node.args[0]
    return node


def qualnames(tree: ast.Module) -> Dict[str, List[ast.AST]]:
    """Every def by its qualified name: the enclosing classes and defs
    joined with "." (``Cls.method``, ``factory.inner``)."""
    out: Dict[str, List[ast.AST]] = {}

    def visit(body, prefix: str) -> None:
        for node in body:
            if isinstance(node, _FUNCS + (ast.ClassDef,)):
                q = prefix + node.name
                if isinstance(node, _FUNCS):
                    out.setdefault(q, []).append(node)
                visit(node.body, q + ".")
            else:
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.stmt, ast.excepthandler)):
                        visit([child], prefix)
    visit(tree.body, "")
    return out


def _enclosing(tree: ast.Module) -> Dict[int, Optional[ast.AST]]:
    """id(node) -> the innermost def enclosing it (None at module level)."""
    parent: Dict[int, Optional[ast.AST]] = {}
    stack = [(tree, None)]
    while stack:
        node, fn = stack.pop()
        for child in ast.iter_child_nodes(node):
            parent[id(child)] = fn
            stack.append((child, child if isinstance(child, _FUNCS)
                          else fn))
    return parent


def _positional(fn: ast.AST) -> List[str]:
    return [a.arg for a in fn.args.posonlyargs + fn.args.args]


class JitPurityPass(Pass):
    pass_id = "jit-purity"
    description = ("no host numpy / host syncs / clocks / IO / Python "
                   "mutation inside autograd Functions, remat and local_map "
                   "bodies, or the port's counterparts of traced functions")

    def run(self, tree: ast.Module, src: str, relpath: str) -> List[Finding]:
        np_names = numpy_aliases(tree)
        defs: Dict[str, List[ast.AST]] = {}
        calls: List[ast.Call] = []
        for node in ast.walk(tree):
            if isinstance(node, _FUNCS):
                defs.setdefault(node.name, []).append(node)
            elif isinstance(node, ast.Call):
                calls.append(node)
        parent = _enclosing(tree)

        traced: List[ast.AST] = []
        seen: Set[int] = set()
        findings: List[Finding] = []

        def mark(node: ast.AST, scope: Optional[ast.AST], depth: int = 0
                 ) -> None:
            node = _unwrap_partial(node)
            if isinstance(node, ast.Name):
                for d in defs.get(node.id, []):
                    mark(d, scope, depth)
                if depth < _MAX_DEPTH and scope is not None:
                    self._follow(node.id, scope, calls, parent,
                                 lambda n, s: mark(n, s, depth + 1))
                return
            if isinstance(node, _FUNCS + (ast.Lambda,)) and \
                    id(node) not in seen:
                seen.add(id(node))
                traced.append(node)

        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and any(
                    dotted_name(b) in _AUTOGRAD_BASES for b in node.bases):
                for m in node.body:
                    if isinstance(m, _FUNCS) and m.name in _AUTOGRAD_METHODS:
                        mark(m, None)
        for node in calls:
            if dotted_name(node.func) in _WRAP_CALLS and node.args:
                mark(node.args[0], parent.get(id(node)))

        by_qualname = qualnames(tree)
        for path, qualname, site in TRACED:
            if path != relpath:
                continue
            if qualname not in by_qualname:
                findings.append(Finding(
                    self.pass_id, relpath, 1,
                    f"TRACED entry {qualname} (reference {site}) names no "
                    "def in this file"))
            for d in by_qualname.get(qualname, []):
                mark(d, None)

        # what a marked body calls in this file runs inside it too
        work = list(traced)
        while work:
            for node in ast.walk(work.pop()):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                if isinstance(f, ast.Attribute) and \
                        isinstance(f.value, ast.Name) and \
                        f.value.id in ("self", "cls"):
                    f = ast.Name(id=f.attr)
                if isinstance(f, ast.Name):
                    for d in defs.get(f.id, []):
                        if id(d) not in seen:
                            seen.add(id(d))
                            traced.append(d)
                            work.append(d)

        for fn in traced:
            findings.extend(self._check_body(fn, np_names, relpath))
        return findings

    @staticmethod
    def _follow(name: str, scope: ast.AST, calls: List[ast.Call], parent,
                mark) -> None:
        """``name`` inside def ``scope``: mark what a local assignment binds
        to it, or, for a parameter, what the file's calls of ``scope``
        pass there."""
        for node in ast.walk(scope):
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name
                    for t in node.targets):
                mark(node.value, scope)
        params = _positional(scope)
        kwonly = [a.arg for a in scope.args.kwonlyargs]
        if name not in params and name not in kwonly:
            return
        for call in calls:
            callee = dotted_name(call.func)
            if callee is None or callee.split(".")[-1] != scope.name:
                continue
            at = parent.get(id(call))
            if name in params:
                i = params.index(name)
                if params and params[0] in ("self", "cls") and \
                        isinstance(call.func, ast.Attribute):
                    i -= 1
                if 0 <= i < len(call.args):
                    mark(call.args[i], at)
            for kw in call.keywords:
                if kw.arg == name:
                    mark(kw.value, at)

    # ------------------------------------------------------------ body walk
    def _check_body(self, fn: ast.AST, np_names: Set[str], relpath: str
                    ) -> List[Finding]:
        findings: List[Finding] = []
        local = _local_names(fn)
        body = fn.body if isinstance(fn.body, list) else [fn.body]
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    findings.append(self.finding(
                        relpath, node,
                        f"{type(node).__name__.lower()} statement inside a "
                        "traced body (Python-level mutation)"))
                elif isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (node.targets
                               if isinstance(node, ast.Assign)
                               else [node.target])
                    for t in targets:
                        findings.extend(self._check_target(t, node, local,
                                                           relpath))
                elif isinstance(node, ast.Call):
                    findings.extend(self._check_call(node, np_names, local,
                                                     relpath))
        return findings

    def _check_target(self, t: ast.AST, node: ast.AST, local: Set[str],
                      relpath: str) -> List[Finding]:
        base = t
        while isinstance(base, (ast.Subscript, ast.Attribute)):
            if isinstance(base, ast.Attribute) and \
                    isinstance(base.value, ast.Name) and \
                    base.value.id == "self":
                return [self.finding(
                    relpath, node,
                    "write to self.* inside a traced body (host state "
                    "mutation: runs again under remat, lost to a "
                    "captured graph)")]
            base = base.value
        if base is not t and isinstance(base, ast.Name) and \
                base.id not in local and base.id != "self":
            what = dotted_name(t) or f"{base.id}[...]"
            return [self.finding(
                relpath, node,
                f"write to non-local {what} inside a traced body "
                "(Python-level mutation)")]
        return []

    def _check_call(self, node: ast.Call, np_names: Set[str],
                    local: Set[str], relpath: str) -> List[Finding]:
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _SYNC_METHODS:
            return [self.finding(
                relpath, node,
                f"host sync .{node.func.attr}() inside a traced body "
                "(waits for the card)")]
        name = dotted_name(node.func)
        if name is None:
            return []
        parts = name.split(".")
        if parts[0] in np_names and len(parts) > 1:
            if parts[1] not in _NP_TRACE_OK:
                return [self.finding(
                    relpath, node,
                    f"host numpy call {name}() inside a traced body "
                    "(host work on the card's path; use torch)")]
            return []
        if parts[0] in _HOST_MODULES and len(parts) > 1:
            return [self.finding(
                relpath, node,
                f"host effect {name}() inside a traced body "
                "(clock/randomness on the host, frozen in a captured "
                "graph)")]
        if name in ("print", "open"):
            return [self.finding(
                relpath, node,
                f"host IO {name}() inside a traced body (move IO outside "
                "the step)")]
        if len(parts) == 2 and parts[1] in _MUTATORS and \
                parts[0] not in local and parts[0] != "self":
            return [self.finding(
                relpath, node,
                f"mutating call {name}() on a non-local object inside a "
                "traced body (Python-level mutation)")]
        return []


def _local_names(fn: ast.AST) -> Set[str]:
    """Names bound inside ``fn`` (params + assignments + loop/with/
    comprehension targets + nested defs/imports)."""
    local: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (args.posonlyargs + args.args + args.kwonlyargs
                  + ([args.vararg] if args.vararg else [])
                  + ([args.kwarg] if args.kwarg else [])):
            local.add(a.arg)

    def add_target(t: ast.AST) -> None:
        # a name binds; ``a.b = ...`` and ``a[i] = ...`` write to ``a``
        if isinstance(t, ast.Name):
            local.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                add_target(e)
        elif isinstance(t, ast.Starred):
            add_target(t.value)

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    add_target(t)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign,
                                   ast.For, ast.AsyncFor, ast.NamedExpr)):
                add_target(node.target)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    if item.optional_vars is not None:
                        add_target(item.optional_vars)
            elif isinstance(node, ast.comprehension):
                add_target(node.target)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                local.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for a in node.names:
                    local.add((a.asname or a.name).split(".")[0])
    return local
