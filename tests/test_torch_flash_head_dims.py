"""Flash attention at the head dims 48, 72, 80, 96 and 112, on the CPU.

The reference's Pallas kernel tiles q, K and V over the whole head dim and
takes any D; the port's kernels take D up to 128: the tensor-core variant
the multiples of 16 (HuBERT X-Large's 80 and Zamba2-7B's 112 among them),
the CUDA-core one every D. On the CPU every wrapper runs its plain version,
which the kernels are held to on the card (tests/test_torch_cuda.py), so
here that plain version is held to the reference:

* ``flash_attention`` (its plain forward) against the Pallas kernel in
  interpret mode, causal and not, GQA (4 q heads over 2 kv heads) at a
  ragged S;
* ``flash_attention_bwd`` (its plain backward, from the forward's out and
  row log-sum-exp) against ``jax.vjp`` of the reference's jnp attention
  (``attention_reference``), and against torch autograd of the plain
  forward;
* a head dim past 128 is refused before anything runs.

fp32, 3e-5 absolute plus 1e-5 relative: the repo's fp32 attention bound
(tests/test_kernels.py), sums in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models.attention import attention_reference
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_lse_ref,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops

ATOL, RTOL = 3e-5, 1e-5
HEAD_DIMS = [48, 72, 80, 96, 112]
B, S, HQ, HKV = 1, 67, 4, 2


def _inputs(D, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, S, HQ, D), (B, S, HKV, D), (B, S, HKV, D),
                      (B, S, HQ, D))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_plain_flash_matches_pallas(D, causal):
    """The port's flash on the CPU against the Pallas kernel in interpret
    mode (blocks of 32 over the ragged 67 rows: three q and kv blocks)."""
    q, k, v, _ = _inputs(D, D + causal)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=causal, device="cpu")
    ref = jax_flash(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                    block_q=32, block_kv=32, interpret=True)
    assert out.shape == (B, S, HQ, D) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", HEAD_DIMS)
def test_plain_flash_bwd_matches_jax_vjp(D, causal):
    """The port's backward (the plain version the backward kernel is held
    to) against ``jax.vjp`` of the reference's ``attention_reference``,
    and against autograd of the port's plain forward."""
    q, k, v, do = _inputs(D, 100 + D + causal)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    out, vjp = jax.vjp(lambda a, b, c: attention_reference(
        a, b, c, pos, pos, causal=causal), *(jnp.asarray(x) for x in
                                             (q, k, v)))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o = flash_attention(tq, tk, tv, causal=causal, device="cpu")
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=ATOL,
                               rtol=RTOL)
    lse = flash_attention_lse_ref(tq, tk, causal=causal)
    grads = flash_attention_bwd(tq, tk, tv, o, lse, tdo, causal=causal,
                                device="cpu")
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    auto = torch.autograd.grad(flash_attention_ref(*leaves, causal=causal),
                               leaves, tdo)
    for name, g, jg, ag in zip("qkv", grads, jgrads, auto):
        assert g.shape == ag.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{name}")
        torch.testing.assert_close(g, ag, atol=ATOL, rtol=RTOL,
                                   msg=f"d{name}")


@pytest.mark.parametrize("D", [129, 136, 256])
def test_head_dims_past_128_raise(D):
    """Past 128 neither variant runs: the wrappers raise, naming the bound,
    on the CPU as on the card."""
    q = torch.zeros(1, 8, 2, D)
    with pytest.raises(ValueError, match="1 to 128"):
        flash_attention(q, q, q, device="cpu")
    with pytest.raises(ValueError, match="1 to 128"):
        flash_attention_bwd(q, q, q, q, torch.zeros(1, 2, 8), q,
                            device="cpu")
    assert fa_ops.MAX_HEAD_DIM == 128
