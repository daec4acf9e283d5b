"""The port's Mamba2 path against the JAX package's, on the CPU.

* ``ssd_ref`` (the plain version of the SSD kernel, also the port's
  ``ssd_chunked``) against the Pallas SSD kernel in interpret mode, the
  reference's ``ssd_chunked`` (``y`` and the final state) and its
  step-by-step recurrence, at the shapes of tests/test_kernels.py (ragged
  S=50 included), with groups and an initial state.
* ``rmsnorm_ref`` against the Pallas RMSNorm kernel in interpret mode.
* Mamba2 ``SMOKE`` through ``forward``, ``prefill`` and ``decode_step`` on
  weights initialised in JAX and converted, and the port's own
  prefill->decode consistency.

Tolerances: 5e-5 for the scan (the bound of tests/test_kernels.py for the
Pallas kernel against its oracles; the cumsum and the sums run in other
orders), 1e-5 for RMSNorm in fp32 (its bound there) and 2e-2 in bf16 (one
rounding of the same fp32 value, a bf16 ulp). The model: 1e-4 in fp32, and
for bf16 compute 2e-2 of the output's largest magnitude (about 2.5 bf16
ulps of it): both frameworks round at the same points (projections, conv,
gate, norm, residual), but from sums in other orders and, for SiLU, from
another evaluation (XLA's CPU rounds each op of x / (1 + exp(-x)) to bf16,
PyTorch rounds once). Hidden values a few ulps apart then reach every
logit through the fp32 head, so the error scales with the hidden state,
not with each logit, and an absolute bound on logits near 0 would measure
the head's fan-in rather than the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mamba2_1_3b as j_mamba
from repro.kernels.rmsnorm import rmsnorm as jax_rmsnorm
from repro.kernels.ssd import ssd as jax_ssd
from repro.kernels.ssd.ref import ssd_sequential_ref
from repro.models import ssm as j_ssm
from repro.models import transformer as jt
from repro_torch import convert
from repro_torch.configs import mamba2_1_3b as t_mamba
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.ssd import ssd, ssd_ref
from repro_torch.models import ssm as t_ssm
from repro_torch.models import transformer as tt

SSD_TOL = 5e-5
MODEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _ssd_inputs(seed, Bz, S, H, P, N, G=1, init=False):
    """The inputs of tests/test_kernels.py's SSD cases, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(Bz, S, H, P)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bz, S, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=H) * 0.3).astype(np.float32)
    B = (rng.normal(size=(Bz, S, G, N)) * 0.3).astype(np.float32)
    C = (rng.normal(size=(Bz, S, G, N)) * 0.3).astype(np.float32)
    D = np.ones(H, np.float32)
    s0 = (rng.normal(size=(Bz, H, P, N)) * 0.3).astype(np.float32) \
        if init else None
    return x, dt, A, B, C, D, s0


def _t(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


SSD_CASES = [
    # (S, H, P, N, chunk, G, initial state)
    (64, 2, 16, 16, 16, 1, False), (96, 4, 32, 16, 32, 1, False),
    (50, 2, 16, 8, 16, 1, False),          # ragged last chunk
    (50, 4, 16, 8, 16, 2, True),           # groups and an initial state
    (6, 8, 16, 16, 256, 2, True),          # a prompt shorter than a chunk
]


@pytest.mark.parametrize("S,H,P,N,chunk,G,init", SSD_CASES)
def test_ssd_plain_matches_reference(S, H, P, N, chunk, G, init):
    x, dt, A, B, C, D, s0 = _ssd_inputs(S + H + G, 2, S, H, P, N, G, init)
    y, final = ssd(*_t(x, dt, A, B, C, D), chunk, *_t(s0), device="cpu")
    assert y.shape == x.shape and final.shape == (2, H, P, N)
    assert final.dtype == torch.float32
    jy, jfinal = j_ssm.ssd_chunked(*(jnp.asarray(a) for a in
                                     (x, dt, A, B, C, D)), chunk,
                                   None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SSD_TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal),
                               atol=SSD_TOL)
    if s0 is None:       # the Pallas kernel starts from zeros
        pallas = jax_ssd(*(jnp.asarray(a) for a in (x, dt, A, B, C, D)),
                         chunk=chunk, interpret=True)
        np.testing.assert_allclose(y.numpy(), np.asarray(pallas),
                                   atol=SSD_TOL)
        rep = H // G
        seq = ssd_sequential_ref(x, dt, A, np.repeat(B, rep, 2),
                                 np.repeat(C, rep, 2), D)
        np.testing.assert_allclose(y.numpy(), seq, atol=SSD_TOL)


def test_ssd_plain_near_fp64_at_model_steps():
    """At the serving shape's chunk (256) and state (128), with steps dt
    drawn as the model's (softplus(N(0,1) - 3), about 0.07), the fp32 scan
    stays within 1e-5 of the fp64 step-by-step recurrence over S=1000. (With
    the JAX tests' dt of about 0.8, the within-chunk cumsum of dt * A
    reaches ~-200, and its fp32 rounding alone nears the 5e-5 bound: the
    card's fp32 checks draw dt as the model does.)"""
    x, dt, A, B, C, D, _ = _ssd_inputs(11, 1, 1000, 8, 64, 128, 2)
    dt = np.log1p(np.exp(np.log(np.expm1(dt)) - 3)).astype(np.float32)
    y, _ = ssd_ref(*_t(x, dt, A, B, C, D), 256)
    seq = ssd_sequential_ref(x, dt, A, np.repeat(B, 4, 2), np.repeat(C, 4, 2),
                             D)
    assert np.abs(y.numpy() - seq).max() < 1e-5


def test_ssd_chunked_is_the_plain_version():
    assert t_ssm.ssd_chunked is ssd_ref


def test_ssd_chunk_size_invariant():
    """The final state carries across chunk boundaries: chunk 16 and one
    chunk of the whole sequence compute the same scan."""
    x, dt, A, B, C, D, s0 = _ssd_inputs(3, 1, 48, 2, 16, 8, 1, True)
    a = ssd_ref(*_t(x, dt, A, B, C, D), 16, *_t(s0))
    b = ssd_ref(*_t(x, dt, A, B, C, D), 48, *_t(s0))
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), v.numpy(), atol=SSD_TOL)


def test_ssd_bf16_io():
    """bf16 x, B, C: y in bf16, the state in fp32, sums in fp32."""
    x, dt, A, B, C, D, _ = _ssd_inputs(4, 1, 40, 4, 16, 16, 1)
    xb, Bb, Cb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, B, C))
    y, final = ssd(xb, *_t(dt, A), Bb, Cb, *_t(D), 16, device="cpu")
    assert y.dtype == torch.bfloat16 and final.dtype == torch.float32
    y32, f32 = ssd_ref(xb.float(), *_t(dt, A), Bb.float(), Cb.float(),
                       *_t(D), 16)
    torch.testing.assert_close(y.float(), y32.to(torch.bfloat16).float())
    torch.testing.assert_close(final, f32)


def _ssd_tc_rounding(x, dt, A, B, C, D, chunk, initial_state=None):
    """``ssd_ref`` with exactly the bf16 roundings of the tensor-core
    kernel (csrc/ssd.cu, "tc"): the masked scores (C_i . B_j)
    exp(seg_i - seg_j) dt_j, the update's x_j exp(seg_last - seg_j) dt_j,
    and the copy of the state that C_i . state reads, each rounded to bf16
    as a product operand; the cumsum, decays, sums and the carried state
    stay fp32. x, B, C hold bf16 values; y is rounded to bf16 at the end."""
    def r(t):
        return t.to(torch.bfloat16).float()

    Bz, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    xf = x.float()
    Bf = B.float().repeat_interleave(H // G, dim=2)
    Cf = C.float().repeat_interleave(H // G, dim=2)
    state = (initial_state.float() if initial_state is not None else
             torch.zeros(Bz, H, P, N))
    Q = min(chunk, S)
    ys = []
    for s0 in range(0, S, Q):
        sl = slice(s0, min(s0 + Q, S))
        xc, Bc, Cc, dtc = xf[:, sl], Bf[:, sl], Cf[:, sl], dt[:, sl]
        q = xc.shape[1]
        seg = torch.cumsum(dtc * A, dim=1)                       # (B,q,H)
        mask = torch.tril(torch.ones(q, q, dtype=torch.bool))
        L = torch.where(mask[None, :, :, None],
                        torch.exp(seg[:, :, None] - seg[:, None, :]), 0.0)
        scores = r(torch.einsum("bihn,bjhn->bijh", Cc, Bc) * L
                   * dtc[:, None])
        y = torch.einsum("bijh,bjhp->bihp", scores, xc)
        y = y + torch.exp(seg)[..., None] * torch.einsum(
            "bihn,bhpn->bihp", Cc, r(state))
        ys.append(y + xc * D[None, None, :, None])
        w = torch.exp(seg[:, -1:] - seg) * dtc                   # (B,q,H)
        state = torch.exp(seg[:, -1])[..., None, None] * state + \
            torch.einsum("bjhp,bjhn->bhpn", r(xc * w[..., None]), Bc)
    return torch.cat(ys, dim=1).to(x.dtype), state


@pytest.mark.parametrize("S", [1024, 1000])      # whole and ragged chunks
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_tensor_core_rounding_within_bf16_tol(S, G):
    """The tensor-core kernel's roundings, in plain PyTorch, at the serving
    chunk (256), state (128) and head dim (64), with the model's steps (dt
    about 0.07) and an initial state: y and the final state stay within
    chip_smoke.py's BF16_TOL (2e-2, absolute and relative) of ``ssd_ref``'s
    fp32 result, and of the JAX ``ssd_chunked`` on the same numpy inputs."""
    tol = 2e-2
    x, dt, A, B, C, D, s0 = _ssd_inputs(S + G, 1, S, 4, 64, 128, G, True)
    dt = np.log1p(np.exp(np.log(np.expm1(dt)) - 3)).astype(np.float32)
    # x, B, C as the kernel reads them: bf16 values
    x, B, C = (a.astype(jnp.bfloat16).astype(np.float32) for a in (x, B, C))
    xb, Bb, Cb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, B, C))
    dtt, At, Dt, s0t = _t(dt, A, D, s0)
    y, final = _ssd_tc_rounding(xb, dtt, At, Bb, Cb, Dt, 256, s0t)
    y_ref, final_ref = ssd_ref(xb, dtt, At, Bb, Cb, Dt, 256, s0t)
    jy, jfinal = j_ssm.ssd_chunked(*(jnp.asarray(a) for a in
                                     (x, dt, A, B, C, D)), 256,
                                   jnp.asarray(s0))
    for ref_y, ref_s in ((y_ref.float(), final_ref),
                         (torch.from_numpy(np.array(jy)),
                          torch.from_numpy(np.array(jfinal)))):
        torch.testing.assert_close(y.float(), ref_y, atol=tol, rtol=tol)
        torch.testing.assert_close(final, ref_s, atol=tol, rtol=tol)
    assert (y.float() - y_ref.float()).abs().max() > 0   # it does round


@pytest.mark.parametrize("bad", ["groups", "dt_dtype", "xb_dtype", "state",
                                 "chunk"])
def test_ssd_wrapper_rejects(bad):
    x, dt, A, B, C, D, s0 = _t(*_ssd_inputs(5, 1, 8, 4, 16, 8, 2, True))
    if bad == "groups":
        B = C = torch.zeros(1, 8, 3, 8)
    elif bad == "dt_dtype":
        dt = dt.to(torch.bfloat16)
    elif bad == "xb_dtype":
        B = B.to(torch.bfloat16)
    elif bad == "state":
        s0 = s0[:, :, :, :4]
    with pytest.raises(ValueError):
        ssd(x, dt, A, B, C, D, 0 if bad == "chunk" else 4, s0, device="cpu")


# ---------------------------------------------------------------- rmsnorm
@pytest.mark.parametrize("shape", [(1, 64), (64, 128), (300, 256),
                                   (3, 5, 2048)])
@pytest.mark.parametrize("gemma", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(shape, gemma, dtype):
    rng = np.random.default_rng(shape[0] * shape[-1])
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    w = rng.normal(size=shape[-1]).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    out = rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                  gemma=gemma, device="cpu")
    assert out.dtype == tdt and out.shape == shape
    ref = jax_rmsnorm(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                      gemma=gemma, interpret=True)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    else:
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(ref.astype(jnp.float32)),
                                   atol=2e-2, rtol=2e-2)


def test_rmsnorm_weight_dtype_is_its_own():
    """w may be bf16 under fp32 x and the reverse; the output takes x's."""
    x = torch.randn(4, 64, generator=torch.Generator().manual_seed(0))
    w = torch.randn(64, generator=torch.Generator().manual_seed(1))
    out = rmsnorm(x, w.to(torch.bfloat16), device="cpu")
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, rmsnorm_ref(
        x, w.to(torch.bfloat16).float()))
    assert rmsnorm(x.to(torch.bfloat16), w, device="cpu").dtype == \
        torch.bfloat16
    with pytest.raises(ValueError):
        rmsnorm(x, torch.ones(32), device="cpu")


# ------------------------------------------------------------------ model
def _configs(dtype="float32"):
    return (j_mamba.SMOKE.replace(compute_dtype=dtype),
            t_mamba.SMOKE.replace(compute_dtype=dtype))


def _weights(jcfg, seed=0):
    jp = jt.init(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S))


def _pos(B, S, start=0):
    return np.broadcast_to(np.arange(start, start + S)[None], (B, S)).copy()


def _close(ours, theirs, tol):
    """fp32: ``tol`` absolute. bf16: ``tol`` relative to the output's
    largest magnitude."""
    ours, theirs = ours.float().numpy(), np.asarray(theirs, np.float32)
    if tol == MODEL_TOL["float32"]:
        np.testing.assert_allclose(ours, theirs, atol=tol)
    else:
        err, scale = np.abs(ours - theirs).max(), np.abs(theirs).max()
        assert err <= tol * scale, (err, scale)


def test_smoke_config_is_the_reference():
    jcfg, tcfg = j_mamba.SMOKE, t_mamba.SMOKE
    for f in ("n_layers", "d_model", "d_inner", "ssm_nheads", "ssm_headdim",
              "ssm_state", "ssm_ngroups", "ssm_conv_width", "ssm_chunk",
              "vocab", "norm_eps"):
        assert getattr(jcfg, f) == getattr(tcfg, f), f
    full = t_mamba.CONFIG
    assert (full.n_layers, full.d_model, full.d_inner, full.ssm_nheads,
            full.ssm_headdim, full.ssm_state, full.vocab) == \
        (48, 2048, 4096, 64, 64, 128, 50280)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [24, 40])        # one and three chunks of 16
def test_forward_matches(dtype, S):
    jcfg, tcfg = _configs(dtype)
    jp, tp = _weights(jcfg, seed=S)
    toks, pos = _tokens(jcfg, 2, S, seed=S), _pos(2, S)
    with torch.inference_mode():
        logits, aux = tt.forward(tp, tcfg, torch.from_numpy(toks),
                                 torch.from_numpy(pos))
    jl, _ = jt.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    assert logits.shape == (2, S, jcfg.vocab) and logits.dtype == torch.float32
    assert float(aux) == 0.0
    _close(logits, jl, MODEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match(dtype):
    jcfg, tcfg = _configs(dtype)
    jp, tp = _weights(jcfg, seed=1)
    B, P = 3, 21
    toks = _tokens(jcfg, B, P + 3, seed=1)
    with torch.inference_mode():
        lg, cache = tt.prefill(tp, tcfg, torch.from_numpy(toks[:, :P]),
                               torch.from_numpy(_pos(B, P)))
    jlg, jcache = jt.prefill(jp, jcfg, jnp.asarray(toks[:, :P]),
                             jnp.asarray(_pos(B, P)))
    _close(lg, jlg, MODEL_TOL[dtype])
    ours = jax.tree.leaves(convert.tree_map(lambda t: t.float().numpy(), cache))
    theirs = jax.tree.leaves(jcache)
    assert len(ours) == len(theirs) == 4
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape
        _close(torch.from_numpy(a), b, MODEL_TOL[dtype])
    for i in range(P, P + 3):
        with torch.inference_mode():
            lg, cache = tt.decode_step(tp, tcfg,
                                       torch.from_numpy(toks[:, i:i + 1]),
                                       torch.from_numpy(_pos(B, 1, i)),
                                       cache, i)
        jlg, jcache = jt.decode_step(jp, jcfg, jnp.asarray(toks[:, i:i + 1]),
                                     jnp.asarray(_pos(B, 1, i)), jcache,
                                     jnp.asarray(i))
        _close(lg, jlg, MODEL_TOL[dtype])
    assert cache["segments"][0]["b0"]["state"].dtype == torch.float32
    assert cache["segments"][0]["b0"]["conv_x"].dtype == tcfg.cdtype


def test_prefill_decode_consistency():
    """tests/test_models_smoke.py's check on the port alone: prefill of a
    prefix then token-by-token decode gives the full forward's logits."""
    tcfg = t_mamba.SMOKE
    tp = tt.init(torch.Generator().manual_seed(0), tcfg)
    B, S = 2, 24
    toks = torch.from_numpy(_tokens(tcfg, B, S, seed=3))
    with torch.inference_mode():
        full, _ = tt.forward(tp, tcfg, toks, torch.from_numpy(_pos(B, S)))
        P = S - 4
        lg, cache = tt.prefill(tp, tcfg, toks[:, :P],
                               torch.from_numpy(_pos(B, P)), s_cache=S)
        errs = [float((lg - full[:, P - 1]).abs().max())]
        for i in range(P, S):
            lg, cache = tt.decode_step(tp, tcfg, toks[:, i:i + 1],
                                       torch.from_numpy(_pos(B, 1, i)),
                                       cache, i)
            errs.append(float((lg - full[:, i]).abs().max()))
    assert max(errs) < 5e-4, errs


def test_decode_does_not_write_its_input_cache():
    tcfg = t_mamba.SMOKE
    tp = tt.init(torch.Generator().manual_seed(1), tcfg)
    cache = tt.init_cache(tcfg, 2, 8, device="cpu")
    before = convert.tree_map(torch.clone, cache)
    _, new = tt.decode_step(tp, tcfg, torch.ones(2, 1, dtype=torch.long),
                            None, cache, 0)
    for a, b in zip(jax.tree.leaves(convert.tree_map(torch.Tensor.numpy,
                                                     before)),
                    jax.tree.leaves(convert.tree_map(torch.Tensor.numpy,
                                                     cache))):
        np.testing.assert_array_equal(a, b)
    assert not torch.equal(new["segments"][0]["b0"]["state"],
                           cache["segments"][0]["b0"]["state"])


def test_lm_convert_round_trip():
    jcfg, tcfg = _configs()
    jp, tp = _weights(jcfg, seed=2)
    jnp_tree = jax.tree.map(np.asarray, jp)
    back = convert.to_jax(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jnp_tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jnp_tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    L = jcfg.n_layers
    seg = tp["segments"][0]["b0"]
    assert seg["mamba"]["w_z"].shape == (L, jcfg.d_model, jcfg.d_inner)
    assert seg["ln"]["scale"].shape == (L, jcfg.d_model)
    assert tp["embed"]["table"].shape == (jcfg.vocab, jcfg.d_model)
    assert tp["head"].shape == (jcfg.d_model, jcfg.vocab)
    # native init draws the same tree: same keys, shapes and dtypes
    native = tt.init(torch.Generator().manual_seed(0), tcfg)
    assert jax.tree.structure(native) == jax.tree.structure(tp)
    for a, b in zip(jax.tree.leaves(native), jax.tree.leaves(tp)):
        assert a.shape == b.shape and a.dtype == b.dtype
