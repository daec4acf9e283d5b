"""The port's LM serving path against the JAX package's: ``ServeEngine``,
``make_prefill_step`` and ``make_serve_step`` on Mamba2 ``SMOKE`` with
weights initialised in JAX and converted, and the launcher on the CPU.

Greedy tokens are compared while every decode call's logits agree within
1e-4 (fp32, as the model tests) and no row's top-2 logit gap falls under
it: within it either side's argmax may legitimately flip, and the tokens
after a flip differ by design, so the comparison stops at the first such
near-tie. With the seeds here none occurs, and every request's tokens must
be equal.

The port's engine clears a refilled slot's cache rows before feeding its
prompt, where the reference's only resets the slot's length (its Mamba
state and conv taps carry over into the next request). Engine runs that
refill slots are held to the JAX engine with the same repair
(``RepairedJServeEngine``); ``test_reused_slot_starts_clear`` pins the
repair on both engines and the reference's fault on the unchanged one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_1_3b as j_mamba
from repro.configs import tinyllama_1_1b as j_llama
from repro.configs import zamba2_7b as j_zamba
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import make_prefill_step as j_make_prefill_step
from repro.train import make_serve_step as j_make_serve_step
from repro.train.checkpoint import save_checkpoint as jax_save
from repro_torch import convert
from repro_torch.configs import mamba2_1_3b as t_mamba
from repro_torch.configs import tinyllama_1_1b as t_llama
from repro_torch.configs import zamba2_7b as t_zamba
from repro_torch.configs import mirage_agent as t_agent
from repro_torch.configs import qwen2_vl_7b as t_qwen2_vl
from repro_torch.launch import serve as t_launch
from repro_torch.models import transformer as tt
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import (make_prefill_step, make_serve_step,
                               save_checkpoint)

TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jp = jt.init(jax.random.PRNGKey(0), j_mamba.SMOKE)
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


class RepairedJServeEngine(JServeEngine):
    """The JAX engine with the port's slot repair: a refilled slot's rows
    of every cache leaf are zeroed before its prompt is fed."""

    def _prefill_slot(self, slot, req):
        self.cache = jax.tree.map(lambda c: c.at[:, slot].set(0), self.cache)
        super()._prefill_slot(slot, req)


def _prompts(n, seed=0):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(0, j_mamba.SMOKE.vocab, k)]
            for k in rng.integers(1, 8, n)]


def _record(eng, log):
    """Keep the logits of every decode call the engine makes."""
    inner = eng._decode

    def decode(*args):
        logits, cache = inner(*args)
        log.append(np.asarray(logits, np.float32))
        return logits, cache
    eng._decode = decode


def test_engine_tokens_match_jax(model):
    """Five requests on 3 slots, so two slots are refilled: against the JAX
    engine with the port's slot repair."""
    jp, tp = model
    jeng = RepairedJServeEngine(j_mamba.SMOKE, jp, batch=3, s_max=32)
    teng = ServeEngine(t_mamba.SMOKE, tp, batch=3, s_max=32, device="cpu")
    jlog, tlog = [], []
    _record(jeng, jlog)
    _record(teng, tlog)
    for eng, make in ((jeng, JRequest), (teng, Request)):
        for rid, prompt in enumerate(_prompts(5)):
            eng.add_request(make(rid=rid, prompt=prompt, max_new=4 + rid))
    jdone, tdone = jeng.run(), teng.run()
    assert [r.rid for r in tdone] == [r.rid for r in jdone] == list(range(5))
    assert len(tlog) == len(jlog) > 20
    near_tie = False
    for j_logits, t_logits in zip(jlog, tlog):
        np.testing.assert_allclose(t_logits, j_logits, atol=TOL)
        top2 = np.sort(j_logits, axis=-1)[:, -2:]
        if (top2[:, 1] - top2[:, 0] < TOL).any():
            near_tie = True
            break
    assert not near_tie, "a near-tie: pick another seed"
    assert [r.out for r in tdone] == [r.out for r in jdone]
    assert all(len(r.out) == 4 + r.rid for r in tdone)


def test_engine_matches_direct_greedy(model):
    """The port's engine against full-forward greedy decoding on the port
    (tests/test_serve.py's oracle), with a second request sharing the
    batch."""
    _, tp = model
    cfg = t_mamba.SMOKE
    prompt, n_new = [5, 17, 42, 9], 6
    toks = list(prompt)
    with torch.inference_mode():
        for _ in range(n_new):
            x = torch.tensor([toks])
            logits, _ = tt.forward(tp, cfg, x, torch.arange(len(toks))[None])
            toks.append(int(logits[0, -1].argmax()))
    eng = ServeEngine(cfg, tp, batch=2, s_max=32, device="cpu")
    eng.add_request(Request(rid=0, prompt=list(prompt), max_new=n_new))
    eng.add_request(Request(rid=1, prompt=[3, 1, 4], max_new=3))
    with torch.inference_mode():
        done = eng.run()
    assert [r.rid for r in done] == [0, 1]
    assert done[0].out == toks[len(prompt):]


def test_engine_eos_and_s_max(model):
    _, tp = model
    eng = ServeEngine(t_mamba.SMOKE, tp, batch=2, s_max=6, device="cpu")
    eng.add_request(Request(rid=0, prompt=[1, 2, 3], max_new=50))
    with torch.inference_mode():
        done = eng.run()
    # lengths start at len(prompt) - 1 = 2 and stop at s_max - 1 = 5
    assert len(done) == 1 and len(done[0].out) == 3
    first = done[0].out[0]
    eng = ServeEngine(t_mamba.SMOKE, tp, batch=2, s_max=64, eos_id=first,
                      device="cpu")
    eng.add_request(Request(rid=0, prompt=[1, 2, 3], max_new=50))
    with torch.inference_mode():
        assert eng.run()[0].out == [first]


def test_engine_rejects_unported_configs(model):
    _, tp = model
    with pytest.raises(ValueError):
        ServeEngine(t_agent.CONFIG, tp, device="cpu")          # encoder
    # M-RoPE, once refused, now serves: Qwen2-VL's SMOKE
    cfg = t_qwen2_vl.SMOKE
    assert cfg.mrope_sections == (4, 2, 2)
    eng = ServeEngine(cfg, tt.init(torch.Generator().manual_seed(0), cfg),
                      batch=2, s_max=16, device="cpu")
    eng.add_request(Request(rid=0, prompt=[1, 2, 3], max_new=4))
    with torch.inference_mode():
        done = eng.run()
    assert len(done) == 1 and len(done[0].out) == 4


def _serve(engine, cfg, params, prompts, **kw):
    """Served one after another in a 1-slot engine: the last prompt's tokens
    and the logits of its decode calls (its prompt's and its own tokens')."""
    eng = engine(cfg, params, batch=1, s_max=32, **kw)
    make = Request if engine is ServeEngine else JRequest
    reqs = [make(rid=i, prompt=p, max_new=6) for i, p in enumerate(prompts)]
    log = []
    _record(eng, log)
    for r in reqs:
        eng.add_request(r)
    with torch.inference_mode():
        eng.run()
    calls = len(prompts[-1]) - 1 + 6
    return reqs[-1].out, np.stack(log[-calls:])


@pytest.mark.parametrize("name", ["mamba2", "zamba2", "tinyllama"])
def test_reused_slot_starts_clear(name):
    """B served after A in a 1-slot engine against B served alone. The
    port's engine clears the slot, so B's logits (within 1e-4) and tokens
    are its own; the JAX engine with the same repair agrees. The unchanged
    JAX engine carries A's Mamba state and conv taps into B (Mamba2,
    Zamba2): B's logits move by over 1e-2. An attention-only model
    (TinyLlama) masks A's stale K/V by the length, so there B is B on
    every engine."""
    jcfg, tcfg = {"mamba2": (j_mamba.SMOKE, t_mamba.SMOKE),
                  "zamba2": (j_zamba.SMOKE, t_zamba.SMOKE),
                  "tinyllama": (j_llama.SMOKE, t_llama.SMOKE)}[name]
    jp = jt.init(jax.random.PRNGKey(3), jcfg)
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(7)
    a, b = ([int(t) for t in rng.integers(0, jcfg.vocab, 6)] for _ in "ab")
    out, logits = _serve(ServeEngine, tcfg, tp, [b], device="cpu")
    for engine, cfg, params, prompts, kw in (
            (ServeEngine, tcfg, tp, [a, b], {"device": "cpu"}),
            (RepairedJServeEngine, jcfg, jp, [a, b], {}),
            (JServeEngine, jcfg, jp, [b], {})):
        o, lg = _serve(engine, cfg, params, prompts, **kw)
        np.testing.assert_allclose(lg, logits, atol=TOL)
        assert o == out
    _, stale = _serve(JServeEngine, jcfg, jp, [a, b])
    moved = float(np.abs(stale - logits).max())
    assert moved > 1e2 * TOL if name != "tinyllama" else moved < TOL


def test_prefill_and_serve_steps_match_jax(model):
    jp, tp = model
    cfg_j, cfg_t = j_mamba.SMOKE, t_mamba.SMOKE
    B, S = 2, 20
    toks = np.random.default_rng(1).integers(0, cfg_j.vocab, (B, S))
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    jlg, jcache = j_make_prefill_step(cfg_j)(jp, jnp.asarray(toks),
                                             jnp.asarray(pos))
    with torch.inference_mode():
        lg, cache = make_prefill_step(cfg_t)(tp, torch.from_numpy(toks),
                                             torch.from_numpy(pos))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL)
    jtok = jnp.argmax(jlg, -1).astype(jnp.int32)[:, None]
    tok = torch.from_numpy(np.array(jtok))
    jserve, serve = j_make_serve_step(cfg_j), make_serve_step(cfg_t)
    for i in range(S, S + 4):
        jtok, jlg, jcache = jserve(jp, jtok, jnp.full((B, 1), i), jcache,
                                   jnp.asarray(i))
        with torch.inference_mode():
            tok, lg, cache = serve(tp, tok, torch.full((B, 1), i), cache, i)
        assert tok.dtype == torch.int32 and tok.shape == (B, 1)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("sample", ["temperature", "top_k"])
def test_serve_step_takes_any_sample_as_the_reference(model, sample):
    """The reference's ``make_serve_step`` takes any ``sample`` string and
    always takes the argmax; the port's does the same: equal tokens and
    logits within 1e-4 over 4 decode steps from one prefill."""
    jp, tp = model
    cfg_j, cfg_t = j_mamba.SMOKE, t_mamba.SMOKE
    B, S = 2, 12
    toks = np.random.default_rng(2).integers(0, cfg_j.vocab, (B, S))
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    jlg, jcache = j_make_prefill_step(cfg_j)(jp, jnp.asarray(toks),
                                             jnp.asarray(pos))
    with torch.inference_mode():
        _, cache = make_prefill_step(cfg_t)(tp, torch.from_numpy(toks),
                                            torch.from_numpy(pos))
    jtok = jnp.argmax(jlg, -1).astype(jnp.int32)[:, None]
    tok = torch.from_numpy(np.array(jtok))
    jserve = j_make_serve_step(cfg_j, sample=sample)
    serve = make_serve_step(cfg_t, sample=sample)
    for i in range(S, S + 4):
        jtok, jlg, jcache = jserve(jp, jtok, jnp.full((B, 1), i), jcache,
                                   jnp.asarray(i))
        with torch.inference_mode():
            tok, lg, cache = serve(tp, tok, torch.full((B, 1), i), cache, i)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=TOL)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_launcher_on_cpu(capsys):
    out = t_launch.main(["--arch", "mamba2-1.3b", "--smoke", "--device",
                         "cpu", "--requests", "3", "--max-new", "4",
                         "--s-max", "32"])
    assert out["arch"] == "mamba2-1.3b" and out["device"] == "cpu"
    assert out["done"] == out["requests"] == 3
    assert out["tokens"] == 12
    assert "3/3 requests done" in capsys.readouterr().out


def test_launcher_refuses_checkpoints(tmp_path):
    """``--ckpt-dir`` restores the LM tree; a checkpoint that lacks its
    leaves is refused, and an empty directory serves fresh weights."""
    save_checkpoint(str(tmp_path), 1, {"other": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing leaf"):
        t_launch.main(["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)])
    out = t_launch.main(["--arch", "mamba2-1.3b", "--smoke", "--device",
                         "cpu", "--requests", "1", "--max-new", "2",
                         "--ckpt-dir", str(tmp_path / "empty")])
    assert out["done"] == 1


def test_launcher_restores_jax_checkpoint(model, tmp_path, capsys):
    """A smoke Mamba2 tree that JAX's ``save_checkpoint`` wrote is restored
    by the port's launcher, which then gives the tokens the port's engine
    gives on the same weights passed directly."""
    jp, tp = model
    jax_save(str(tmp_path), 7, {"params": jp})
    argv = ["--arch", "mamba2-1.3b", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "4", "--s-max", "32"]
    out = t_launch.main(argv + ["--ckpt-dir", str(tmp_path)])
    assert "restored weights from step 7" in capsys.readouterr().out
    eng = ServeEngine(t_mamba.SMOKE, tp, batch=4, s_max=32, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=[int(t) for t in rng.integers(
        0, t_mamba.SMOKE.vocab_size, 6)], max_new=4) for i in range(3)]
    for r in reqs:
        eng.add_request(r)
    while eng.queue or any(r is not None for r in eng.slot_req):
        eng.step()
    assert out["outputs"] == [r.out for r in reqs]
    fresh = t_launch.main(argv)
    assert fresh["outputs"] != out["outputs"]


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_launch.main(["--smoke", "--requests", "1"])
