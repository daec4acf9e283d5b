"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX, nor the JAX package, nor ``msgpack`` (the card's machine has
none of them), and entry points run on CUDA unless the caller asks for the
CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

BLOCKER = r"""
import importlib, importlib.util, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro", "msgpack"):
            raise ImportError("blocked import of " + name)

sys.meta_path.insert(0, Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "repro", "msgpack"))
assert not bad, bad
import torch.distributed
assert not torch.distributed.is_initialized()   # nothing joins at import
for name in ("repro_torch.dist.sharding", "repro_torch.launch.mesh",
             "repro_torch.launch.dryrun", "repro_torch.roofline.hw",
             "repro_torch.roofline.analysis", "repro_torch.roofline.scope"):
    assert name in names, name
print(len(names))
"""


def test_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", BLOCKER,
                          str(ROOT / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 92       # every module imported


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_names_no_jax_or_repro(path):
    src = (ROOT / path).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|repro)\b", src, re.M), \
        path


def _entry_points():
    from repro_torch.convert import from_jax
    from repro_torch.core import (DQNConfig, DQNLearner, FoundationConfig,
                                  PGConfig, PGLearner, build_policy,
                                  init_foundation, pretrain_foundation)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.moe_gemm import expert_mlp, grouped_gemm
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_bwd
    from repro_torch.kernels.ssd import ssd, ssd_bwd
    from repro_torch.configs import mamba2_1_3b
    from repro_torch.data import DataConfig, data_iterator, synth_batch
    from repro_torch.examples import (provision_service, quickstart,
                                      serve_decode, train_lm)
    from repro_torch.launch import provision, serve, train
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine
    from repro_torch.train import (ChainConfig, ChainedTrainer,
                                   OptimizerConfig, restore_checkpoint)
    fc = FoundationConfig().reduced()
    x = torch.zeros(1, 4, 8)
    q = torch.zeros(1, 4, 2, 16)
    h = torch.zeros(2)
    s = torch.zeros(1, 4, 2, 16)
    b = torch.zeros(1, 4, 1, 8)
    return {
        "rmsnorm": lambda: rmsnorm(x, torch.ones(8)),
        "rmsnorm_bwd": lambda: rmsnorm_bwd(x, torch.ones(8), x),
        "ssd": lambda: ssd(s, torch.zeros(1, 4, 2), h, b, b, h, 4),
        "ssd_bwd": lambda: ssd_bwd(s, torch.zeros(1, 4, 2), h, b, b, h, 4, s),
        "synth_batch": lambda: synth_batch(mamba2_1_3b.SMOKE, DataConfig(), 0),
        "data_iterator": lambda: next(data_iterator(mamba2_1_3b.SMOKE,
                                                    DataConfig())),
        "ChainedTrainer": lambda: ChainedTrainer(
            mamba2_1_3b.SMOKE, OptimizerConfig(), ChainConfig(), iter([])),
        "launch.train": lambda: train.main(["--smoke", "--steps", "1"]),
        "init_cache": lambda: transformer.init_cache(mamba2_1_3b.SMOKE, 1, 8),
        "ServeEngine": lambda: ServeEngine(mamba2_1_3b.SMOKE, {}),
        "launch.serve": lambda: serve.main(["--smoke", "--requests", "1"]),
        "launch.provision": lambda: provision.main(["--method", "reactive"]),
        "restore_checkpoint": lambda: restore_checkpoint("missing", {}),
        "DQNLearner": lambda: DQNLearner(fc, DQNConfig()),
        "PGLearner": lambda: PGLearner(fc, PGConfig()),
        "pretrain_foundation": lambda: pretrain_foundation(fc, []),
        "build_policy": lambda: build_policy("moe+dqn", None,
                                             offline_samples=[{}]),
        "flash_attention_bwd": lambda: flash_attention_bwd(
            q, q, q, q, torch.zeros(1, 2, 4), q),
        "init_foundation": lambda: init_foundation(torch.Generator(), fc),
        "flash_attention": lambda: flash_attention(q, q, q),
        "grouped_gemm": lambda: grouped_gemm(x, torch.zeros(1, 8, 8)),
        "expert_mlp": lambda: expert_mlp(x, torch.zeros(1, 8, 2, 8),
                                         torch.zeros(1, 8, 8)),
        "from_jax": lambda: from_jax({"gate": torch.zeros(1).numpy(),
                                      "experts": {}}),
        "examples.quickstart": lambda: quickstart.main([]),
        "examples.train_lm": lambda: train_lm.main([]),
        "examples.serve_decode": lambda: serve_decode.main([]),
        "examples.provision_service": lambda: provision_service.main([]),
    }


@pytest.mark.parametrize("name", ["DQNLearner", "PGLearner",
                                  "pretrain_foundation", "build_policy",
                                  "init_foundation", "flash_attention",
                                  "flash_attention_bwd", "grouped_gemm",
                                  "expert_mlp", "from_jax", "rmsnorm", "ssd",
                                  "init_cache", "ServeEngine",
                                  "launch.serve", "launch.provision",
                                  "restore_checkpoint", "rmsnorm_bwd",
                                  "ssd_bwd", "synth_batch", "data_iterator",
                                  "ChainedTrainer", "launch.train",
                                  "examples.quickstart", "examples.train_lm",
                                  "examples.serve_decode",
                                  "examples.provision_service"])
def test_entry_points_default_to_cuda(name):
    """Without ``device=`` an entry point asks for CUDA: where there is no
    card it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        _entry_points()[name]()


def test_resolve_device():
    from repro_torch.device import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda:0")
    # the meta device (shapes only, the dry run's) only when asked for
    assert resolve_device("meta") == torch.device("meta")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_cpu_tensors_need_cpu_device():
    """A wrapper given CPU tensors for another device raises, never runs."""
    from repro_torch.kernels.moe_gemm import grouped_gemm
    from repro_torch.device import check_on
    x = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        check_on(torch.device("cuda"), x)
    assert grouped_gemm(x, torch.zeros(1, 8, 3), device="cpu").shape == (1, 4, 3)
