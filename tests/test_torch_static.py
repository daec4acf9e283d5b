"""The port's static invariant gate (``repro_torch.analysis``): a fixture
corpus with a true positive and a clean example per pass, in PyTorch's
terms, the suppression syntax, the baseline diff, the repo-wide gate over
``src/repro_torch`` with the committed baseline, the ``TRACED`` table held
to the reference's ``jax.jit``/``lax.scan`` sites, and the lazy exports of
``repro_torch.train`` and ``repro_torch.analysis``. No JAX is imported:
the reference package is read as text, by ``ast``, in one test only.
"""
import ast
import os
import pathlib
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import (DtypeDisciplinePass, ImportDisciplinePass,
                                  JitPurityPass, LaneLoopPass, analyze_source,
                                  diff_baseline)
from repro_torch.analysis import imports as imports_mod
from repro_torch.analysis import purity
from repro_torch.analysis.runner import (BASELINE, all_passes, analyze_tree,
                                         load_baseline, save_baseline)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"

HOT = "repro_torch/core/state.py"        # lane-loop + dtype contract module
MODEL = "repro_torch/models/blocks.py"   # float32-contract module
F32_CORE = "repro_torch/core/dqn.py"     # float32-contract, outside models/
ANY = "repro_torch/sim/simulator.py"


def run_pass(p, src, relpath=ANY, suppress=True):
    return analyze_source(textwrap.dedent(src), relpath, [p],
                          suppress=suppress)


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


# ---------------------------------------------------------- import-discipline
BAD_IMPORT = """
    import numpy as np
    import torch
    import zstandard
"""

CLEAN_IMPORT = """
    import os
    import numpy as np
    import torch
    from repro_torch.models import transformer
    try:
        import zstandard as zstd
    except ImportError:
        zstd = None

    def late():
        import triton  # deferred to use time: allowed
        return triton
"""


def test_import_discipline_true_positive():
    f = run_pass(ImportDisciplinePass(), BAD_IMPORT)
    assert len(f) == 1 and f[0].pass_id == "import-discipline"
    assert "zstandard" in f[0].message


def test_import_discipline_clean():
    assert run_pass(ImportDisciplinePass(), CLEAN_IMPORT) == []


@pytest.mark.parametrize("pkg", ["scipy", "einops", "msgpack", "triton",
                                 "zstandard"])
def test_optional_packages_need_a_guard(pkg):
    f = run_pass(ImportDisciplinePass(), f"import {pkg}\n")
    assert len(f) == 1 and f"'{pkg}'" in f[0].message
    guarded = f"""
        try:
            import {pkg}
        except ImportError:
            {pkg} = None
    """
    assert run_pass(ImportDisciplinePass(), guarded) == []


def test_import_discipline_lazy_init_contract():
    eager = "from .chain import ChainConfig\n"
    f = run_pass(ImportDisciplinePass(), eager,
                 relpath="repro_torch/train/__init__.py")
    ids = {x.message for x in f}
    assert any("eager relative import" in m for m in ids)
    assert any("__getattr__" in m for m in ids)
    lazy = """
        from typing import TYPE_CHECKING
        if TYPE_CHECKING:
            from .chain import ChainConfig

        def __getattr__(name):
            raise AttributeError(name)
    """
    assert run_pass(ImportDisciplinePass(), lazy,
                    relpath="repro_torch/train/__init__.py") == []


@pytest.mark.parametrize("relpath", imports_mod.LAZY_INITS)
def test_eager_relative_import_in_each_lazy_init(relpath):
    src = """
        from .base import Finding

        def __getattr__(name):
            raise AttributeError(name)
    """
    f = run_pass(ImportDisciplinePass(), src, relpath=relpath)
    assert len(f) == 1 and "eager relative import" in f[0].message
    # the same file outside the lazy set is an ordinary package init
    assert run_pass(ImportDisciplinePass(), src,
                    relpath="repro_torch/models/__init__.py") == []


@pytest.mark.parametrize("stmt", [
    "import jax", "import jax.numpy as jnp", "from jax import lax",
    "import jaxlib", "from repro.core import x", "import repro.models",
    "importlib.import_module('jax.numpy')", "__import__('repro')"])
def test_no_jax_or_reference_import_anywhere(stmt):
    src = f"""
        import importlib

        def late():
            try:
                {stmt}
            except ImportError:
                pass
    """
    f = run_pass(ImportDisciplinePass(), src)
    assert len(f) == 1 and "in the port" in f[0].message, f
    # under TYPE_CHECKING too
    src = f"""
        import importlib
        from typing import TYPE_CHECKING
        if TYPE_CHECKING:
            {stmt}
    """
    assert len(run_pass(ImportDisciplinePass(), src)) == 1


def test_port_package_names_are_not_the_reference():
    src = """
        import repro_torch
        from repro_torch.train import checkpoint

        def late():
            from repro_torch.core import agent
            return agent
    """
    assert run_pass(ImportDisciplinePass(), src) == []


BAD_BUILD = """
    import ctypes
    from repro_torch.kernels import _build

    LIB = _build.load("rmsnorm")
"""


@pytest.mark.parametrize("src", [
    BAD_BUILD,
    """
    from repro_torch.kernels._build import build
    build(["ssd"])
    """,
    """
    import ctypes
    _LIB = ctypes.CDLL("libx.so")
    """,
    """
    from .. import _build as b

    class K:
        fn = b.load("moe_gemm")
    """,
    """
    from repro_torch.kernels import _build

    def launch(x, fn=_build.load("flash_attention")):
        return fn(x)
    """,
])
def test_module_level_kernel_build(src):
    f = run_pass(ImportDisciplinePass(), src)
    assert len(f) == 1 and "at import time" in f[0].message, f


def test_kernel_build_at_first_use_is_clean():
    src = """
        import ctypes
        from repro_torch.kernels import _build

        def launch(x):
            fn = _build.load("rmsnorm")
            return fn(x)

        LAUNCH = lambda x: _build.load("ssd")(x)
    """
    assert run_pass(ImportDisciplinePass(), src) == []


# ---------------------------------------------------------------- jit-purity
BAD_FN_NUMPY = """
    import numpy as np
    import torch

    class Scale(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            scale = np.sqrt(x.shape[-1])   # host numpy on the card's path
            return x * scale

        @staticmethod
        def backward(ctx, g):
            return g
"""

BAD_CHECKPOINT_CLOCK = """
    import time
    import torch
    from torch.utils.checkpoint import checkpoint

    def outer(x):
        def body(h):
            t = time.time()            # runs again in the recompute
            return h * t
        return checkpoint(body, x, use_reentrant=False)
"""

BAD_MUTATION = """
    import torch
    log = []

    class Keep(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            log.append(x)              # Python-level mutation
            return x

        @staticmethod
        def backward(ctx, g):
            return g
"""

CLEAN_FN = """
    import numpy as np
    import torch

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            acc = torch.zeros(x.shape, dtype=np.float32)  # trace-time ok
            out = []
            out.append(acc + x @ w)    # local list: fine
            ctx.save_for_backward(x, w)
            ctx.scale = 2.0
            ctx.mark_non_differentiable(acc)
            return out[0]

        @staticmethod
        def backward(ctx, g):
            x, w = ctx.saved_tensors
            return g @ w.T, x.T @ g

    def host(x):
        print(float(x.sum().item()))   # not traced: host work is fine
        return np.sqrt(x.numpy())
"""


def test_jit_purity_true_positives():
    f = run_pass(JitPurityPass(), BAD_FN_NUMPY)
    assert len(f) == 1 and "np.sqrt" in f[0].message
    f = run_pass(JitPurityPass(), BAD_CHECKPOINT_CLOCK)
    assert len(f) == 1 and "time.time" in f[0].message
    f = run_pass(JitPurityPass(), BAD_MUTATION)
    assert len(f) == 1 and "log.append" in f[0].message


def test_jit_purity_clean():
    assert run_pass(JitPurityPass(), CLEAN_FN) == []


def test_jit_purity_partial_through_a_local_name():
    src = """
        import functools
        import numpy as np
        from torch.utils.checkpoint import checkpoint

        def _body(x, eps):
            return x * np.float64(eps)

        def op(x, eps):
            body = functools.partial(_body, eps=eps)
            return checkpoint(body, x, use_reentrant=False)
    """
    f = run_pass(JitPurityPass(), src)
    assert len(f) == 1 and "np.float64" in f[0].message


@pytest.mark.parametrize("call", ["x.sum().item()", "x.tolist()",
                                  "x.cpu()", "x.detach().numpy()",
                                  "torch.cuda.synchronize()",
                                  "torch.cuda.current_stream().synchronize()"])
def test_host_sync_in_autograd_forward(call):
    src = f"""
        import torch

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                n = {call}
                return x

            @staticmethod
            def backward(ctx, g):
                return g
    """
    f = run_pass(JitPurityPass(), src)
    assert len(f) == 1 and "host sync" in f[0].message, f


def test_print_in_a_checkpoint_body():
    src = """
        from torch.utils.checkpoint import checkpoint

        def block(x):
            def ffn(h):
                print(h.shape)
                return h * 2
            return checkpoint(ffn, x, use_reentrant=False)
    """
    f = run_pass(JitPurityPass(), src)
    assert len(f) == 1 and "print" in f[0].message


def test_append_to_a_non_local_name_in_a_local_map_lambda():
    src = """
        from torch.distributed.tensor.experimental import local_map
        seen = []

        def sharded(x, mesh):
            fn = local_map(lambda t: seen.append(t) or t,
                           out_placements=None, device_mesh=mesh)
            return fn(x)
    """
    f = run_pass(JitPurityPass(), src)
    assert len(f) == 1 and "seen.append" in f[0].message


def test_checkpoint_body_passed_through_a_parameter():
    """``_branch(fn, x)`` checkpoints ``fn``: what the file's callers pass
    there is the body (``models/blocks.py``'s form)."""
    src = """
        import time
        from torch.utils.checkpoint import checkpoint

        def _branch(fn, x):
            return checkpoint(fn, x, use_reentrant=False)

        def block(x):
            def attention(h):
                return h + time.monotonic()
            def ffn(h):
                return h * 2
            return _branch(ffn, _branch(attention, x))
    """
    f = run_pass(JitPurityPass(), src)
    assert len(f) == 1 and "time.monotonic" in f[0].message


def test_helper_called_from_a_marked_body():
    src = """
        import torch

        def _launch(x):
            return x * x.abs().max().item()

        def _count(out):
            _launch.launches += 1   # repro-static: ok[jit-purity] counter

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                out = _launch(x)
                _count(out)
                return out

            @staticmethod
            def backward(ctx, g):
                return g
    """
    f = run_pass(JitPurityPass(), src)
    assert len(f) == 1 and ".item()" in f[0].message
    raw = run_pass(JitPurityPass(), src, suppress=False)
    assert any("non-local _launch.launches" in x.message for x in raw)


def test_traced_table_marks_its_entries():
    """An entry of ``TRACED`` is checked in its own file only, and an entry
    whose def is gone is a finding of its own."""
    src = """
        import time

        def _forward_body(seg, layer, cfg, positions, x, aux):
            time.sleep(0)
            return x, aux
    """
    rel = "repro_torch/models/transformer.py"
    f = run_pass(JitPurityPass(), src, relpath=rel)
    msgs = [x.message for x in f]
    assert any("time.sleep" in m for m in msgs)
    assert any("TRACED entry apply_trunk" in m for m in msgs)
    assert run_pass(JitPurityPass(), src, relpath=MODEL) == []


def test_write_to_self_in_a_traced_method():
    src = """
        class ServeEngine:
            def _decode(self, toks, idxs):
                self.calls = 1
                return toks
    """
    f = run_pass(JitPurityPass(), src, relpath="repro_torch/serve/engine.py")
    assert len(f) == 1 and "self.*" in f[0].message


# ----------------------------------------------------------------- lane-loop
BAD_LOOP = """
    def encode(sims):
        out = []
        for b, s in enumerate(sims):
            out.append(s.now)
        return out
"""

CLEAN_LOOP = """
    def pcts(vals):
        total = 0.0
        for v in vals:                 # not the lane axis
            total += v
        return total
"""


def test_lane_loop_true_positive():
    f = run_pass(LaneLoopPass(), BAD_LOOP, relpath=HOT)
    assert len(f) == 1 and f[0].pass_id == "lane-loop"


def test_lane_loop_clean_and_scoped():
    assert run_pass(LaneLoopPass(), CLEAN_LOOP, relpath=HOT) == []
    # outside the designated hot modules the pass does not apply
    assert run_pass(LaneLoopPass(), BAD_LOOP,
                    relpath="repro_torch/core/agent.py") == []
    # nor to the reference's paths
    assert run_pass(LaneLoopPass(), BAD_LOOP,
                    relpath="repro/core/state.py") == []


COPIED = {"repro_torch/sim/simulator.py": 3,
          "repro_torch/core/provisioner.py": 3,
          "repro_torch/core/state.py": 4}


@pytest.mark.parametrize("rel", sorted(COPIED))
def test_copied_lane_loop_suppressions_are_honoured(rel):
    """The ``ok[lane-loop]`` comments copied with the reference's modules
    count: the file is clean modulo the baseline with them, and each one
    taken out is a finding."""
    src = (PORT.parent / rel).read_text()
    marker = re.compile(r"\s*# repro-static: ok\[lane-loop\].*$", re.M)
    assert len(marker.findall(src)) == COPIED[rel]
    base = load_baseline(BASELINE)
    fresh, _ = diff_baseline(analyze_source(src, rel, [LaneLoopPass()]),
                             base)
    assert fresh == []
    fresh, _ = diff_baseline(
        analyze_source(marker.sub("", src), rel, [LaneLoopPass()]), base)
    assert len(fresh) == COPIED[rel], fresh


def test_removing_one_suppression_fails_the_gate(tmp_path):
    copy = tmp_path / "repro_torch"
    shutil.copytree(PORT, copy, ignore=shutil.ignore_patterns(
        "__pycache__", "csrc"))
    sim = copy / "sim" / "simulator.py"
    src = sim.read_text()
    line = "for s in sims:   # repro-static: ok[lane-loop] per-simulator " \
           "event advance"
    assert src.count(line) == 1
    sim.write_text(src.replace(line, "for s in sims:"))
    fresh, stale = diff_baseline(analyze_tree(copy, all_passes()),
                                 load_baseline(BASELINE))
    assert stale == {}
    assert [(f.pass_id, f.path) for f in fresh] == [
        ("lane-loop", "repro_torch/sim/simulator.py")]
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--root", str(copy)], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "FAILED" in out.stdout, out.stdout


# ----------------------------------------------------------- dtype-discipline
BAD_DTYPE = """
    import numpy as np
    buf = np.zeros(16)
"""

CLEAN_DTYPE = """
    import numpy as np
    buf = np.zeros(16, np.float64)
    conv = np.asarray(buf)             # conversion: dtype-preserving, exempt
    like = np.zeros_like(buf)
"""

BAD_MODEL_F64 = """
    import numpy as np
    import torch

    def embed(x):
        table = np.zeros((4, 4), np.float64)
        return torch.as_tensor(table) + x
"""


def test_dtype_discipline_true_positive():
    f = run_pass(DtypeDisciplinePass(), BAD_DTYPE, relpath=HOT)
    assert len(f) == 1 and "dtype-less" in f[0].message


def test_dtype_discipline_clean():
    assert run_pass(DtypeDisciplinePass(), CLEAN_DTYPE, relpath=HOT) == []


def test_dtype_discipline_model_float64():
    f = run_pass(DtypeDisciplinePass(), BAD_MODEL_F64, relpath=MODEL)
    assert len(f) == 1 and "float32-contract" in f[0].message
    # the same source in a float64-contract module is fine
    assert run_pass(DtypeDisciplinePass(), BAD_MODEL_F64, relpath=HOT) == []


@pytest.mark.parametrize("expr", ["x.to(torch.float64)",
                                  "x.to(torch.double)", "x.double()"])
def test_torch_float64_in_a_float32_module(expr):
    src = f"""
        import torch

        def q(x):
            return {expr}
    """
    f = run_pass(DtypeDisciplinePass(), src, relpath=F32_CORE)
    assert len(f) == 1 and "float32-contract" in f[0].message, f
    assert run_pass(DtypeDisciplinePass(), src, relpath=HOT) == []
    assert run_pass(DtypeDisciplinePass(), src,
                    relpath="repro_torch/core/agent.py") == []


def test_torch_allocation_without_dtype_and_device():
    src = """
        import torch

        def mask(n):
            return torch.zeros(n)
    """
    f = run_pass(DtypeDisciplinePass(), src, relpath=MODEL)
    assert sorted(x.message.split("without ")[1][:7] for x in f) == [
        "device=", "dtype= "]
    f = run_pass(DtypeDisciplinePass(), src, relpath=F32_CORE)
    assert len(f) == 2


@pytest.mark.parametrize("fn", ["zeros", "ones", "empty", "full", "arange",
                                "tensor", "randn", "rand", "linspace"])
def test_each_torch_factory_states_dtype_and_device(fn):
    args = {"full": "(n,), 0.0", "linspace": "0.0, 1.0, n",
            "tensor": "[1.0]"}.get(fn, "n")
    bare = f"import torch\nx = torch.{fn}({args})\n"
    assert len(analyze_source(bare, MODEL, [DtypeDisciplinePass()])) == 2
    stated = (f"import torch\nx = torch.{fn}({args}, dtype=torch.float32, "
              "device=y.device)\n")
    assert analyze_source(stated, MODEL, [DtypeDisciplinePass()]) == []


def test_torch_conversions_and_likes_are_exempt():
    src = """
        import torch

        def f(x, kw):
            a = torch.as_tensor([1, 2])
            b = torch.zeros_like(x)
            c = torch.full_like(x, 2.0)
            d = x.new_zeros(3)
            e = torch.zeros(3, **kw)   # dtype and device may be in kw
            return a, b, c, d, e
    """
    assert run_pass(DtypeDisciplinePass(), src, relpath=MODEL) == []


# -------------------------------------------------- suppressions + baseline
def test_line_suppression():
    src = """
        import numpy as np
        buf = np.zeros(16)   # repro-static: ok[dtype-discipline] scratch
    """
    assert run_pass(DtypeDisciplinePass(), src, relpath=HOT) == []
    # the raw finding is still produced pre-suppression
    assert len(run_pass(DtypeDisciplinePass(), src, relpath=HOT,
                        suppress=False)) == 1


def test_file_suppression_and_wildcard():
    src = """
        # repro-static: skip-file[lane-loop] generated adapter
        def encode(sims):
            for b, s in enumerate(sims):
                pass
    """
    assert run_pass(LaneLoopPass(), src, relpath=HOT) == []
    src_all = (textwrap.dedent(BAD_DTYPE)
               + "# repro-static: skip-file[*] vendored\n")
    assert analyze_source(src_all, HOT) == []


def test_wrong_pass_id_does_not_suppress():
    src = """
        import numpy as np
        buf = np.zeros(16)   # repro-static: ok[lane-loop] wrong id
    """
    assert len(run_pass(DtypeDisciplinePass(), src, relpath=HOT)) == 1


def test_baseline_diff_counts():
    f = run_pass(DtypeDisciplinePass(), BAD_DTYPE, relpath=HOT)
    base = {f[0].fingerprint: 1}
    fresh, stale = diff_baseline(f, base)
    assert fresh == [] and stale == {}
    # a second identical finding exceeds the budget
    fresh, stale = diff_baseline(f + f, base)
    assert len(fresh) == 1 and stale == {}
    # an unused entry is reported stale
    fresh, stale = diff_baseline([], base)
    assert fresh == [] and stale == base


def test_baseline_round_trip(tmp_path):
    f = run_pass(DtypeDisciplinePass(), BAD_DTYPE, relpath=HOT)
    path = tmp_path / "baseline.json"
    save_baseline(f + f, path)
    assert load_baseline(path) == {f[0].fingerprint: 2}
    assert load_baseline(tmp_path / "missing.json") == {}


# ------------------------------------------------------------- repo-wide gate
def test_src_tree_clean_modulo_baseline():
    """The committed tree passes every pass with the committed baseline,
    and no entry of the baseline is stale — the in-suite mirror of
    ``python -m repro_torch.analysis``."""
    findings = analyze_tree(PORT, all_passes())
    baseline = load_baseline(BASELINE)
    fresh, stale = diff_baseline(findings, baseline)
    assert fresh == [], "non-baselined findings:\n" + "\n".join(
        str(f) for f in fresh)
    assert stale == {}


def test_baseline_holds_only_the_two_provisioner_loops():
    """Each entry is debt that ROADMAP names with the work that clears
    it: the reference's two grandfathered loops, under the port's path."""
    base = load_baseline(BASELINE)
    assert sorted(base) == [
        "lane-loop::repro_torch/core/provisioner.py::Python for-loop over "
        "the lane/batch axis (`for c0 in range(0, len(lanes), B)`) in a "
        "vectorized hot module",
        "lane-loop::repro_torch/core/provisioner.py::Python for-loop over "
        "the lane/batch axis (`for i, f in zip(sub_idx, forced[submit])`) "
        "in a vectorized hot module"]
    assert set(base.values()) == {1}
    roadmap = (ROOT / "ROADMAP.md").read_text()
    for key in base:
        loop = key.split("(`")[1].split("`)")[0]
        assert loop in roadmap, loop


def test_pass_ids_unique_and_stable():
    ids = [p.pass_id for p in all_passes()]
    assert ids == ["import-discipline", "jit-purity", "lane-loop",
                   "dtype-discipline"]
    assert len(set(ids)) == len(ids)


@pytest.mark.parametrize("args,rc,text", [
    ([], 0, "repro_torch.analysis: OK"),
    (["lane-loop", "dtype-discipline"], 0, "lane-loop=2, dtype-discipline=0"),
    (["no-such-pass"], 2, "unknown pass id"),
    (["lane-loop", "--update-baseline"], 2, "requires running all passes"),
])
def test_cli(args, rc, text):
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          *args], env=_env(), capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == rc, out.stdout + out.stderr
    assert text in out.stdout


# ------------------------------------------------ TRACED against the reference
_JIT = {"jax.jit", "jit"}
_SCAN = {"jax.lax.scan", "lax.scan"}


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return ".".join([node.id] + parts[::-1])
    return None


def _reference_sites():
    """``repro/<file>:<line>`` of every ``jax.jit`` call or decorator
    (``functools.partial(jax.jit, ...)`` included) and ``lax.scan`` call
    in the reference package, its analysis passes aside."""
    sites = set()
    for path in sorted(REF.rglob("*.py")):
        rel = path.relative_to(REF.parent).as_posix()
        if rel.startswith("repro/analysis/"):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call):
                name = _dotted(node.func)
                if name in _JIT | _SCAN or (
                        name in ("functools.partial", "partial")
                        and node.args and _dotted(node.args[0]) in _JIT):
                    sites.add(f"{rel}:{node.lineno}")
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    if _dotted(dec) in _JIT:
                        sites.add(f"{rel}:{dec.lineno}")
    return sites


def test_traced_table_covers_the_reference():
    """Every reference file with a ``jax.jit``/``lax.scan`` site and a
    counterpart in the port is named by a ``TRACED`` entry; every site is
    named; no entry names a site that is not one; each entry resolves to a
    def in its port file."""
    sites = _reference_sites()
    named = {site for _, _, site in purity.TRACED}
    assert named <= sites, sorted(named - sites)
    assert sites <= named, sorted(sites - named)
    files = {s.rsplit(":", 1)[0] for s in sites}
    covered = {s.rsplit(":", 1)[0] for s in named}
    with_port = {f for f in files
                 if (PORT.parent / f.replace("repro/", "repro_torch/",
                                             1)).exists()}
    assert with_port <= covered, sorted(with_port - covered)
    assert len(with_port) >= 14
    for path, qualname, site in purity.TRACED:
        tree = ast.parse((PORT.parent / path).read_text())
        assert qualname in purity.qualnames(tree), (path, qualname, site)


def test_traced_bodies_are_marked():
    """Each ``TRACED`` def is walked: a host sync put into any of them is
    a finding."""
    for path, qualname, _ in purity.TRACED:
        src = (PORT.parent / path).read_text()
        tree = ast.parse(src)
        fn = purity.qualnames(tree)[qualname][0]
        lines = src.splitlines()
        body0 = fn.body[0]
        if isinstance(body0, ast.Expr) and isinstance(
                getattr(body0, "value", None), ast.Constant):
            body0 = fn.body[1]          # after the docstring
        indent = " " * body0.col_offset
        lines.insert(body0.lineno - 1, indent + "_probe = _x.item()")
        f = analyze_source("\n".join(lines), path, [JitPurityPass()])
        assert any(x.line == body0.lineno and "host sync" in x.message
                   for x in f), (path, qualname)


# ------------------------------------------------------------ lazy exports
LAZY_PROBE = r"""
import sys
import repro_torch.train.optimizer
heavy = sorted(m for m in ("repro_torch.train.checkpoint",
                           "repro_torch.train.chain",
                           "repro_torch.train.fault",
                           "repro_torch.train.step") if m in sys.modules)
print(heavy)
import repro_torch.analysis
assert "repro_torch.analysis.runner" not in sys.modules
from repro_torch.analysis import cow
print("ok")
"""


def test_optimizer_import_leaves_checkpoint_and_chain_out():
    out = subprocess.run([sys.executable, "-c", LAZY_PROBE], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    heavy, ok = out.stdout.split("\n")[:2]
    assert heavy == "[]" and ok == "ok"


def test_train_exports_resolve():
    import repro_torch.train as T
    from repro_torch.train import (AsyncCheckpointer, ChainConfig,  # noqa
                                   ChainedTrainer, ElasticPlan,
                                   OptimizerConfig, PreemptionGuard,
                                   StragglerMonitor, adamw_update,
                                   global_norm, init_opt_state, latest_step,
                                   lr_schedule, make_error_feedback_transform,
                                   make_prefill_step, make_serve_step,
                                   make_train_step, restore_checkpoint,
                                   save_checkpoint, value_and_grad)
    from repro_torch.train import checkpoint, step  # submodules still import
    assert T.__all__ == sorted(T._EXPORTS)
    for name, mod in T._EXPORTS.items():
        assert getattr(T, name) is getattr(
            sys.modules[f"repro_torch.train.{mod}"], name)
    assert set(dir(T)) >= set(T.__all__)
    assert checkpoint.save_checkpoint is T.save_checkpoint
    assert step.make_train_step is T.make_train_step
    with pytest.raises(AttributeError):
        T.no_such_name


def test_analysis_exports_resolve():
    import repro_torch.analysis as A
    for name, mod in A._EXPORTS.items():
        assert getattr(A, name) is getattr(
            sys.modules[f"repro_torch.analysis.{mod}"], name)
    assert A.cow.enabled() in (True, False)
    assert "cow" in A.__all__ and "cow" in dir(A)
    with pytest.raises(AttributeError):
        A.no_such_name
