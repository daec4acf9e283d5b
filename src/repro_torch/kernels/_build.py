"""Build the CUDA sources in ``repro_torch/csrc`` and load them with ctypes.

Each ``<name>.cu`` is compiled by nvcc for ``sm_90a`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds). Libraries land in ``<repo>/build/kernels/``, named by a hash of
the sources and flags, so an edited source is rebuilt and a stale library
is never loaded. Nothing is compiled when a module is imported: ``load``
builds on first use, and ``build`` compiles several sources at once, one
nvcc process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# variant codes of the kernels' two kernels each: the CUDA-core one, and the
# tensor-core one (flash, the GEMM, the SSD scan and its backward) or the
# 16-byte-vector one (RMSNorm and its backward)
VARIANT_CODES = {"simt": 0, "tc": 1, "vec": 1}
# form codes of the flash kernels' tensor-core variant (the C entries' last
# argument): the entry's own choice from the shapes, or the form named
FORM_CODES = {"auto": 0, "short": 1, "stream": 2, "wg": 3}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of each library's entry points: {function: argtypes}, the
# first one the library's default
SIGNATURES = {
    "flash_attention": {"flash_attention_fwd":
                        [_P] * 5 + [_I] * 8 + [_L] * 9 + [_I, _I, _F, _F, _P, _I]},
    "flash_attention_bwd": {"flash_attention_bwd":
                            [_P] * 11 + [_I] * 9 + [_L] * 9
                            + [_I, _I, _F, _F, _P, _I]},
    "moe_gemm": {"grouped_gemm": [_P] * 3 + [_I] * 7 + [_L] * 4 + [_P],
                 "grouped_gemm_bwd": [_P] * 7 + [_I] * 5 + [_L] * 6 + [_P]},
    "rmsnorm": {"rmsnorm_fwd":
                [_P, _P, _P, _I, _I, _I, _I, _I, _L, _F, _I, _P]},
    "rmsnorm_bwd": {"rmsnorm_bwd":
                    [_P] * 6 + [_I] * 5 + [_L, _I, _I, _F, _I, _P, _I]},
    "ssd": {"ssd_fwd": [_P] * 9 + [_I] * 9 + [_L] * 12 + [_P]},
    "ssd_bwd": {"ssd_bwd": [_P] * 23 + [_I] * 9 + [_L] * 12 + [_P]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build with the CUDA toolkit's nvcc")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile each named source that has no up-to-date library, all nvcc
    processes started together. Returns nvcc's output (register and shared
    memory use, from ``-Xptxas=-v``) by name; raises if any build fails."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            failed.append(name)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, entry: str = ""):
    """The C entry point ``entry`` (by default the first of SIGNATURES) of
    kernel library ``name``, built on first use."""
    with _lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _libs[name] = lib
        return getattr(_libs[name], entry or next(iter(SIGNATURES[name])))


def row_strides(t):
    """A (B, S, H, D)-shaped tensor's batch, sequence and head strides, 0 for
    an axis of length 1 (a kernel never steps along it)."""
    return [s if n > 1 else 0 for s, n in zip(t.stride()[:3], t.shape[:3])]


def check_launch(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")

