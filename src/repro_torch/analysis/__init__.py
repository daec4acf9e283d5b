"""Static invariant analyzer of the port, and the runtime checks copied
from ``repro.analysis``.

Four AST passes, the reference's read in PyTorch's terms, turn the
port's prose contracts into enforced checks over ``src/repro_torch``
(``python -m repro_torch.analysis`` drives them; tier-1 holds them
through ``tests/test_torch_static.py``):

* ``import-discipline`` — optional-dependency policy, PEP 562 lazy
  ``__init__``\\ s, no import of jax or the reference package, no kernel
  build at import (``repro_torch.analysis.imports``);
* ``jit-purity``       — no host effects in autograd Functions, remat and
  ``local_map`` bodies, or the counterparts of the reference's jitted and
  scanned functions (``repro_torch.analysis.purity``);
* ``lane-loop``        — no Python loops over the batch axis in the
  vectorized hot modules (``repro_torch.analysis.loops``);
* ``dtype-discipline`` — explicit dtypes, no float64 in the model path,
  torch allocations there stating dtype and device
  (``repro_torch.analysis.dtypes``).

``repro_torch.analysis.cow`` is the runtime half: the copy-on-write
aliasing sanitizer that the simulator consults on ``fork()``.

Exports are lazy (PEP 562) so the simulator's sanitizer probe doesn't
pay for — and the analyzer itself keeps honest about — eager imports.
"""
from typing import TYPE_CHECKING

_EXPORTS = {
    "Finding": "base",
    "Pass": "base",
    "apply_suppressions": "base",
    "parse_suppressions": "base",
    "DtypeDisciplinePass": "dtypes",
    "ImportDisciplinePass": "imports",
    "JitPurityPass": "purity",
    "LaneLoopPass": "loops",
    "all_passes": "runner",
    "analyze_source": "runner",
    "analyze_tree": "runner",
    "diff_baseline": "runner",
    "load_baseline": "runner",
    "save_baseline": "runner",
}

__all__ = sorted(_EXPORTS) + ["cow"]

if TYPE_CHECKING:  # pragma: no cover - static analysis only
    from . import cow  # noqa: F401
    from .base import (Finding, Pass, apply_suppressions,  # noqa: F401
                       parse_suppressions)
    from .dtypes import DtypeDisciplinePass  # noqa: F401
    from .imports import ImportDisciplinePass  # noqa: F401
    from .loops import LaneLoopPass  # noqa: F401
    from .purity import JitPurityPass  # noqa: F401
    from .runner import (all_passes, analyze_source,  # noqa: F401
                         analyze_tree, diff_baseline, load_baseline,
                         save_baseline)


def __getattr__(name: str):
    import importlib
    if name == "cow":
        return importlib.import_module(".cow", __name__)
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS) | {"cow"})
