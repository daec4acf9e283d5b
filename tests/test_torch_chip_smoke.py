"""``chip_smoke.py``'s helpers on the CPU: a profiler session in which
CUPTI hands back no device event is run again, a bounded number of times,
and the profile fails if none of them recorded any; phase 8's expected
launches count remat's recompute; phase 8's Command-R cut has the
reference's parameter count and a step's launches; the Qwen1.5-4B and
Zamba2-7B depths chosen on meta tensors; phase 8d's dry-run process and
record."""
import importlib.util
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _event(name, start, end):
    return SimpleNamespace(name=name,
                           time_range=SimpleNamespace(start=start, end=end))


@pytest.mark.parametrize("empty", [0, 1, 2, 3])
def test_profile_device_runs_again_when_no_device_event(smoke, monkeypatch,
                                                        capsys, empty):
    """The first ``empty`` sessions record nothing on the device; the
    profile comes from the first session that does, and fails after
    PROFILE_TRIES empty ones."""
    assert smoke.PROFILE_TRIES == 3
    calls = {"fn": 0, "sessions": 0}

    def fn():
        calls["fn"] += 1

    def profiled(f):
        f()
        calls["sessions"] += 1
        if calls["sessions"] <= empty:
            return 1000.0, []
        return 1000.0, [_event("k_a", 0.0, 300.0), _event("k_b", 200.0, 500.0),
                        _event("k_a", 600.0, 700.0)]

    monkeypatch.setattr(smoke, "_profiled", profiled)
    if empty >= smoke.PROFILE_TRIES:
        with pytest.raises(RuntimeError, match="no device activity"):
            smoke.profile_device("x", fn, 2, "step", warmup=1)
        assert calls == {"fn": 1 + smoke.PROFILE_TRIES,
                         "sessions": smoke.PROFILE_TRIES}
        return
    rec = smoke.profile_device("x", fn, 2, "step", warmup=1, batch=4)
    assert calls == {"fn": 2 + empty, "sessions": 1 + empty}
    assert rec["sessions"] == 1 + empty and rec["batch"] == 4
    assert rec["wall_ms_per_step"] == pytest.approx(0.5)
    assert rec["device_busy_share"] == pytest.approx(0.6)    # 0-500, 600-700
    assert rec["device_ms_per_step"] == pytest.approx(0.35)
    assert rec["device_calls_per_step"] == 1.5
    assert [k["name"] for k in rec["kernels"]] == ["k_a", "k_b"]
    assert rec["kernels"][0]["calls_per_step"] == 1.0
    out = capsys.readouterr().out.splitlines()
    retries = [json.loads(s.split(" ", 1)[1]) for s in out
               if s.startswith("[profile_retry]")]
    assert [r["attempt"] for r in retries] == list(range(1, empty + 1))
    assert sum(s.startswith("[profile] ") for s in out) == 1


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b",
                                  "qwen2-moe-a2.7b", "gemma3-27b"])
def test_train_counts_count_the_recompute(smoke, arch):
    """Phase 8's expected launches with remat (the configs' default): the
    forward kernels twice a pass but the final norm, the backward ones as
    without remat."""
    from repro_torch.models import registry
    cfg = registry.get_config(arch)
    if arch != "zamba2-7b":
        cfg = cfg.replace(attn_impl="flash")
    on = smoke._train_pass_counts(cfg, 3)
    off = smoke._train_pass_counts(cfg.replace(remat=False), 3)
    for k in ("flash_attention", "ssd", "grouped_gemm"):
        assert on[k] == 2 * off[k]
    assert on["rmsnorm"] == 2 * off["rmsnorm"] - 3       # final norm once
    for k in off:
        if "bwd" in k:
            assert on[k] == off[k]
    assert off["rmsnorm"] == off["rmsnorm_bwd"] > 0


def test_command_r_training_cut(smoke):
    """Phase 8's Command-R run: its cut (the tied table and the first
    layers, on meta tensors) has the reference's count that ``cmdr_train``
    holds it to; it is the deepest whose donated 2 x 2048 step, counted
    on meta tensors, peaks at or under the 75.90 GB the card ran 4 layers
    at before the tied table's gradient was one buffer (one layer more
    passes the card's 80 GB), at the layers' stacked gradient; and a step
    launches a flash a layer
    forward, twice with the recompute, and one backward, all on the tensor
    cores in the Hopper streaming form, and no RMSNorm, SSD or grouped
    GEMM (LayerNorm, a dense block)."""
    from repro_torch.launch.dryrun import MetaGenerator
    from repro_torch.models import transformer
    cfg = smoke.CMDR_TRAIN
    params = transformer.init(MetaGenerator(), cfg)
    n = []
    smoke.tree_map(lambda t: n.append(t.numel()), params)
    assert sum(n) == smoke.CMDR_TRAIN_PARAMS
    assert cfg.attn_impl == "flash" and cfg.norm_style == "layer"
    L = cfg.n_layers
    ocfg = smoke.DEEPSEEK_TRAIN_OCFG
    assert ocfg.state_dtype == "bfloat16"
    gb, op = smoke.meta_step_peak(cfg, ocfg, 2, 2048)
    more, _ = smoke.meta_step_peak(cfg.replace(n_layers=L + 1), ocfg, 2,
                                   2048)
    assert gb <= 75.90 < 80 < more and op == "stack"
    got = smoke._train_pass_counts(cfg, 1)
    assert {k: v for k, v in got.items() if v} == {
        "flash_attention": 2 * L, "flash_tc": 2 * L, "flash_wg": 2 * L,
        "flash_attention_bwd": L, "flash_bwd_tc": L, "flash_bwd_wg": L}


@pytest.mark.parametrize("name", ["QWEN4B_TRAIN", "ZAMBA_TRAIN"])
def test_training_depths_chosen_on_meta_tensors(smoke, name):
    """Phase 8's Qwen1.5-4B and Zamba2-7B runs: the depth is the deepest
    (Qwen1.5-4B: all 40 layers; Zamba2-7B: in whole groups of its plan)
    whose donated 2 x 2048 step, counted on meta tensors, peaks at or
    under the 75.90 GB of Command-R's 4-layer run on the card, and the
    next group does not; Zamba2's cut has the parameter count
    ``zamba_train`` holds it to."""
    from repro_torch.launch.dryrun import MetaGenerator
    from repro_torch.models import transformer
    cfg = getattr(smoke, name)
    gb, _ = smoke.meta_step_peak(cfg, smoke.TRAIN_OCFG, 2, 2048)
    assert gb <= 75.90
    if name == "QWEN4B_TRAIN":
        assert cfg == smoke.qwen1_5_4b.CONFIG and cfg.n_layers == 40
        return
    more, _ = smoke.meta_step_peak(
        cfg.replace(n_layers=cfg.n_layers + cfg.attn_every),
        smoke.TRAIN_OCFG, 2, 2048)
    assert more > 75.90 and cfg.n_layers % cfg.attn_every == 4
    n = []
    smoke.tree_map(lambda t: n.append(t.numel()),
                   transformer.init(MetaGenerator(), cfg))
    assert sum(n) == smoke.ZAMBA_TRAIN_PARAMS


def test_dryrun_process_and_its_record(smoke, monkeypatch, tmp_path,
                                       capsys):
    """Phase 8d starts the dry run's cell in a process of its own with no
    card, and prints its ``[ ok ]`` line and record; a cell that did not
    print one fails the phase."""
    seen = {}

    class Proc:
        def __init__(self, cmd, env, **kw):
            seen.update(cmd=cmd, env=env)
            self.returncode = 0

        def communicate(self, timeout):
            return "[ ok ] tinyllama-1.1b x train_4k x 16x16: mem/dev=1\n", ""

    monkeypatch.setattr(smoke, "DRYRUN_DIR", tmp_path)
    monkeypatch.setattr(smoke.subprocess, "Popen", Proc)
    proc = smoke.start_dryrun()
    assert seen["cmd"][1:] == ["-m", "repro_torch.launch.dryrun", "--arch",
                               "tinyllama-1.1b", "--shape", "train_4k",
                               "--out", str(tmp_path)]
    assert seen["env"]["CUDA_VISIBLE_DEVICES"] == ""
    tmp_path.mkdir(exist_ok=True)
    (tmp_path / "tinyllama-1.1b__train_4k__16x16.json").write_text(
        json.dumps({"arch": "tinyllama-1.1b", "status": "ok", "tag": ""}))
    smoke.phase_dryrun(proc)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[ ok ] tinyllama-1.1b x train_4k")
    assert json.loads(out[1].split(" ", 1)[1])["record"]["status"] == "ok"
    proc.communicate = lambda timeout: ("[FAIL] x\n", "")
    with pytest.raises(RuntimeError, match="dry run"):
        smoke.phase_dryrun(proc)
