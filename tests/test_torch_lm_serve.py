"""The port's LM serving path against the JAX package's: ``ServeEngine``,
``make_prefill_step`` and ``make_serve_step`` on Mamba2 ``SMOKE`` with
weights initialised in JAX and converted, and the launcher on the CPU.

Greedy tokens are compared while every decode call's logits agree within
1e-4 (fp32, as the model tests) and no row's top-2 logit gap falls under
it: within it either side's argmax may legitimately flip, and the tokens
after a flip differ by design, so the comparison stops at the first such
near-tie. With the seeds here none occurs, and every request's tokens must
be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_1_3b as j_mamba
from repro.models import transformer as jt
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import make_prefill_step as j_make_prefill_step
from repro.train import make_serve_step as j_make_serve_step
from repro_torch import convert
from repro_torch.configs import mamba2_1_3b as t_mamba
from repro_torch.configs import mirage_agent as t_agent
from repro_torch.launch import serve as t_launch
from repro_torch.models import ModelConfig
from repro_torch.models import transformer as tt
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import make_prefill_step, make_serve_step

TOL = 1e-4


@pytest.fixture(scope="module")
def model():
    jp = jt.init(jax.random.PRNGKey(0), j_mamba.SMOKE)
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


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
    jp, tp = model
    jeng = JServeEngine(j_mamba.SMOKE, jp, batch=3, s_max=32)
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
    with pytest.raises(NotImplementedError):
        ServeEngine(ModelConfig(), tp, device="cpu")           # KV cache


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
    out = t_launch.main(["--smoke", "--device", "cpu", "--requests", "3",
                         "--max-new", "4", "--s-max", "32"])
    assert out["arch"] == "mamba2-1.3b" and out["device"] == "cpu"
    assert out["done"] == out["requests"] == 3
    assert out["tokens"] == 12
    assert "3/3 requests done" in capsys.readouterr().out


def test_launcher_refuses_checkpoints():
    with pytest.raises(NotImplementedError, match="checkpoint"):
        t_launch.main(["--smoke", "--device", "cpu", "--ckpt-dir", "x"])


def test_launcher_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_launch.main(["--smoke", "--requests", "1"])
