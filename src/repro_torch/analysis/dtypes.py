"""``dtype-discipline`` — the float64/float32 dtype contracts as checks,
the reference's over the port's copies, with the port's explicit-device
rule put at the allocation site beside them.

The encoder/simulator path computes in float64 (CSR sample flats,
percentile kernel inputs) and emits float32 observation slabs; the model
path is float32 (or the config's compute dtype) end to end. Dtype drift
between the two silently breaks the bit-identical batched-vs-scalar
contract; a float64 tensor in the model path promotes a whole forward
pass and halves the card's rate.

Three checks:

* **dtype-less numpy allocations** — ``np.array``/``zeros``/``empty``/
  ``ones``/``full`` without an explicit dtype in any contract module.
  (``np.asarray`` is exempt: a conversion that preserves its input's
  dtype.)
* **off-contract dtype** — any ``np.float64``/``np.double``,
  ``torch.float64``/``torch.double`` reference or ``.double()`` call in a
  float32-contract (model-path) module.
* **torch allocations without dtype or device** — in the model-path
  modules, ``torch.zeros``/``ones``/``empty``/``full``/``arange``/
  ``tensor``/``randn``/``rand``/``linspace`` without ``dtype=`` and
  without ``device=`` (one finding each): the entry points run on the
  card unless the caller asks for the CPU, so where a tensor is made is a
  choice the allocation states. (``*_like`` and ``torch.as_tensor`` are
  exempt: they follow their input.)
"""
from __future__ import annotations

import ast
import fnmatch
from typing import List

from .base import (Finding, Pass, call_kwarg_names, dotted_name,
                   has_kwargs_splat, numpy_aliases, torch_aliases)

#: float64 compute contract (encoder/simulator path)
FLOAT64_MODULES = (
    "repro_torch/sim/simulator.py",
    "repro_torch/sim/multitenant.py",
    "repro_torch/core/state.py",
    "repro_torch/core/provisioner.py",
)

#: float32 contract (model path) — fnmatch patterns
FLOAT32_MODULES = (
    "repro_torch/models/*.py",
    "repro_torch/core/dqn.py",
    "repro_torch/core/pg.py",
    "repro_torch/core/foundation.py",
)

#: allocation call -> index of the positional dtype argument
_ALLOC_DTYPE_POS = {"array": 1, "zeros": 1, "empty": 1, "ones": 1, "full": 2}
_F64_NAMES = {"float64", "double"}
#: torch factories whose dtype and device the model path states
_TORCH_ALLOC = {"zeros", "ones", "empty", "full", "arange", "tensor",
                "randn", "rand", "linspace"}


class DtypeDisciplinePass(Pass):
    pass_id = "dtype-discipline"
    description = ("explicit dtypes on np allocations in contract modules; "
                   "no float64 in the float32 model path; torch "
                   "allocations there state dtype and device")

    def applies(self, relpath: str) -> bool:
        return relpath in FLOAT64_MODULES or any(
            fnmatch.fnmatch(relpath, p) for p in FLOAT32_MODULES)

    def run(self, tree: ast.Module, src: str, relpath: str) -> List[Finding]:
        np_names = numpy_aliases(tree)
        torch_names = torch_aliases(tree)
        is_f32 = any(fnmatch.fnmatch(relpath, p) for p in FLOAT32_MODULES)
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                if is_f32 and isinstance(node.func, ast.Attribute) and \
                        node.func.attr == "double" and not node.args:
                    findings.append(self.finding(
                        relpath, node,
                        ".double() in a float32-contract model-path module "
                        "(implicit promotion risk)"))
                    continue
                name = dotted_name(node.func)
                if name is None:
                    continue
                parts = name.split(".")
                if len(parts) == 2 and parts[0] in np_names and \
                        parts[1] in _ALLOC_DTYPE_POS:
                    pos = _ALLOC_DTYPE_POS[parts[1]]
                    has_dtype = (len(node.args) > pos
                                 or "dtype" in call_kwarg_names(node))
                    if not has_dtype:
                        findings.append(self.finding(
                            relpath, node,
                            f"dtype-less {name}() in a dtype-contract "
                            "module (pin the contract dtype explicitly)"))
                elif is_f32 and len(parts) == 2 and \
                        parts[0] in torch_names and \
                        parts[1] in _TORCH_ALLOC and \
                        not has_kwargs_splat(node):
                    kw = call_kwarg_names(node)
                    for arg in ("dtype", "device"):
                        if arg not in kw:
                            findings.append(self.finding(
                                relpath, node,
                                f"{name}() without {arg}= in a model-path "
                                f"module (state the {arg} at the "
                                "allocation)"))
            elif is_f32 and isinstance(node, ast.Attribute):
                name = dotted_name(node)
                if name is not None:
                    parts = name.split(".")
                    if len(parts) == 2 and \
                            (parts[0] in np_names or parts[0] in torch_names) \
                            and parts[1] in _F64_NAMES:
                        findings.append(self.finding(
                            relpath, node,
                            f"{name} referenced in a float32-contract "
                            "model-path module (implicit promotion risk)"))
        return findings
