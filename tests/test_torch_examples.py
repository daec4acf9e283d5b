"""The port's four examples (``repro_torch.examples``) on the CPU, at
``--device cpu`` and small flags, each held to the reference example
(``examples/*.py``, loaded by path and run here with the same flags) where
the two compute the same thing.

quickstart's control-plane lines are the reference example's: the
simulator, the policies and ``evaluate_batch`` are numpy in both packages.
Its data plane trains the reduced config, whose parameter count is JAX's.
train_lm's scaled config line is the reference's for a dense, an MoE and an
SSM family; its loss falls (the example asserts it) and a second invocation
resumes at the first one's step from its checkpoint. serve_decode's engine,
given the reference example's warmed weights (``convert.from_jax``), serves
the reference engine's tokens. provision_service with ``avg`` prints the
reference's lines (the timings aside): its scenario, env, policy, outcomes
and closing sweep are numpy in both; it and an RL method run over two
sub-jobs, the successor resuming from its predecessor's checkpoint with no
payload step lost, and the sweep's summaries finite.
"""
import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.serve
import repro.train
import repro_torch.train
from repro.models import registry as j_registry
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.examples import (provision_service, quickstart,
                                  serve_decode, train_lm)
from repro_torch.models import registry as t_registry

ROOT = Path(__file__).resolve().parents[1]


def _reference(name):
    """The reference example ``examples/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(monkeypatch, name, args):
    """The reference example's ``main`` under ``sys.argv`` = args; returns
    its stdout's lines."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    _, lines = _stdout(_reference(name).main)
    return lines


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue().splitlines()


def test_quickstart_control_plane_is_the_reference():
    _, ref_lines = _stdout(_reference("quickstart").control_plane_demo)
    out, lines = _stdout(quickstart.main, ["--device", "cpu"])
    cut = lines.index("=== data plane: tinyllama-1.1b (reduced config) ===")
    assert lines[:cut] == ref_lines and len(ref_lines) == 4
    summaries = out["control_plane"]["summaries"]
    assert set(summaries) == {"reactive", "avg"}
    assert all(s["n_episodes"] == 4 for s in summaries.values())
    # the data plane: JAX's parameter count, 20 finite losses
    jcfg = j_registry.get_config("tinyllama-1.1b", smoke=True)
    shapes = jax.eval_shape(lambda k: jt.init(k, jcfg),
                            jax.random.PRNGKey(0))
    n = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    assert out["data_plane"]["params"] == n
    assert lines[cut + 1] == f"params: {n:,}"
    assert len(out["data_plane"]["losses"]) == 20
    assert np.isfinite(out["data_plane"]["losses"]).all()
    assert lines[-1].startswith("final loss=")


class _Stop(Exception):
    pass


def _stop(self):
    raise _Stop


def _stdout_until_stop(fn, *args):
    """The lines fn prints before it raises _Stop."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(_Stop):
        fn(*args)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-moe-a2.7b",
                                  "mamba2-1.3b"])
def test_train_lm_scaled_config_is_the_reference(monkeypatch, tmp_path,
                                                  arch):
    """The family scaled down the reference's way: the line that names the
    config and its parameter count is the reference example's, both
    stopped where they would resume and train."""
    args = ["--arch", arch, "--d-model", "64", "--layers", "2",
            "--batch", "2", "--seq", "16", "--vocab", "128",
            "--ckpt-dir", str(tmp_path)]
    monkeypatch.setattr(repro.train.ChainedTrainer, "maybe_resume", _stop)
    monkeypatch.setattr(repro_torch.train.ChainedTrainer, "maybe_resume",
                        _stop)
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *args])
    ref_lines = _stdout_until_stop(_reference("train_lm").main)
    lines = _stdout_until_stop(train_lm.main, args + ["--device", "cpu"])
    assert len(lines) == 1 and lines[0].startswith(
        f"arch={arch} scaled config: ")
    assert lines == ref_lines


@pytest.fixture
def one_intra_op_thread():
    """200 steps of a 2-layer, d-64 model are ops of a few hundred
    microseconds: at the process's default of one intra-op thread a core,
    OpenMP's threads spin between them, and with the suite's other
    workers on the same cores a step took 1.8 s where it takes 0.1 s on
    one thread. The test runs on one; the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_lm_loss_falls_and_resumes(tmp_path, capsys,
                                         one_intra_op_thread):
    """Two invocations on one checkpoint directory, each a sub-job of 100
    steps of the dense family scaled down: the first starts at 0, the
    second resumes at 100, continues the data stream there and ends at
    200; each one's loss falls (the example asserts it)."""
    args = ["--device", "cpu", "--steps", "100", "--d-model", "64",
            "--layers", "2", "--batch", "8", "--seq", "64", "--vocab", "128",
            "--ckpt-dir", str(tmp_path)]
    first = train_lm.main(args)
    second = train_lm.main(args)
    assert (first["resumed"], first["start_step"], first["steps_done"]) == (
        False, 0, 100)
    assert (second["resumed"], second["start_step"],
            second["steps_done"]) == (True, 100, 200)
    assert "resumed from step 100" in capsys.readouterr().out
    for run in (first, second):
        assert len(run["losses"]) == 100
        assert np.isfinite(run["losses"]).all()
        assert run["last10"] < run["first10"]
    assert second["last10"] < first["last10"] < np.log(128)


def test_serve_decode_finishes_every_request(capsys):
    out = serve_decode.main(["--device", "cpu", "--warm-steps", "3"])
    assert out["done"] == out["requests"] == 6 and out["tokens"] == 72
    assert sorted(out["outputs"]) == list(range(6))
    assert all(len(o) == 12 for o in out["outputs"].values())
    assert "served 6 requests, 72 tokens" in capsys.readouterr().out


def test_serve_decode_serves_the_reference_tokens(monkeypatch):
    """The reference example warms its model 3 steps and serves its 6
    requests on 4 slots (two slots refilled); the port's serving, given
    those weights, serves the same tokens to each request and prints the
    same request lines."""
    engines = []

    class Recorded(repro.serve.ServeEngine):
        def __init__(self, cfg, params, **kw):
            super().__init__(cfg, params, **kw)
            engines.append(self)
            self.warm_params = params

        def run(self):
            self.done = super().run()
            return self.done

    monkeypatch.setattr(repro.serve, "ServeEngine", Recorded)
    ref_lines = _run_reference(monkeypatch, "serve_decode",
                               ["--warm-steps", "3"])
    (ref,) = engines
    params = convert.from_jax(jax.tree.map(np.asarray, ref.warm_params),
                              device="cpu")
    cfg = t_registry.get_config("tinyllama-1.1b", smoke=True)
    (done, _), lines = _stdout(serve_decode.serve, cfg, params,
                               torch.device("cpu"))
    assert [r.rid for r in done] == [r.rid for r in ref.done]
    assert sorted(r.rid for r in done) == list(range(6))
    assert [r.out for r in done] == [r.out for r in ref.done]
    assert all(len(r.out) == 12 for r in done)
    requests = [ln for ln in ref_lines if ln.startswith("  req")]
    assert len(requests) == 3 and lines[1:] == requests


@pytest.mark.parametrize("method", ["avg", "transformer+dqn"])
def test_provision_service_resumes_every_subjob(capsys, method):
    """Two sub-jobs of 10 payload steps: the successor resumes at step 10
    from its predecessor's checkpoint, so none of the 20 is lost; the
    closing sweep's summaries (the method's and reactive's) are finite."""
    out = provision_service.main(["--device", "cpu", "--method", method,
                                  "--episodes", "2", "--eval-lanes", "1"])
    assert out["lost_steps"] == 0 and out["total_steps"] == 20
    assert [s["payload_step"] for s in out["subjobs"]] == [10, 20]
    assert all(np.isfinite(s["losses"]).all() and len(s["losses"]) == 10
               for s in out["subjobs"])
    for summary in (out["summary"], out["reactive_summary"]):
        assert summary["n_episodes"] == 1
        assert all(np.isfinite(float(v)) for v in summary.values())
    assert "preserved across sub-jobs: 20 (0 lost" in capsys.readouterr().out


_SECONDS = re.compile(r" \(\d+s\)$")


def test_provision_service_prints_the_reference_lines(monkeypatch):
    """With ``avg`` the control plane is numpy in both packages: the
    scenario, its env, the policy's decisions, each sub-job's outcome and
    the closing sweep's mean interruption hours. Every line the reference
    example prints is the port's, with the seconds taken cut from the two
    timed lines."""
    args = ["--method", "avg", "--episodes", "2", "--eval-lanes", "2"]
    ref_lines = _run_reference(monkeypatch, "provision_service", args)
    out, lines = _stdout(provision_service.main, args + ["--device", "cpu"])
    assert len(lines) == len(ref_lines) == 7
    assert sum(bool(_SECONDS.search(ln)) for ln in ref_lines) == 2
    assert [_SECONDS.sub("", ln) for ln in lines] == [
        _SECONDS.sub("", ln) for ln in ref_lines]
    assert [ln.split(":")[0] for ln in lines[3:5]] == [
        "  ep0 payload@step 10", "  ep1 payload@step 20"]
    assert out["lost_steps"] == 0
