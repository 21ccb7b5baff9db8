"""Kernel 2 in full: the port's two flash entries (kernels.flash, the plain
versions their Functions run on a CPU tensor) against the JAX package's
flash_attention / flash_attention_cached, whose Pallas kernel runs in
interpret mode on the CPU; and the gradients of both entries, and one
Hessian-vector product, against jax.grad through the JAX custom VJPs.

Tolerances:
  * f32 values: rtol 2e-4 / atol 2e-5, the JAX package's own kernel bar
    (online vs dense softmax, f32 summation order);
  * f16 inputs: the JAX entry casts f16 to bf16 before its kernel (Mosaic
    has no f16 vector type) and the port reads f16 as it is, so the two
    differ by the bf16 rounding of q, k and v: atol 2^-8 * max|v| (one bf16
    half-ulp of v and of the scores' inputs, through the softmax average);
  * gradients and HVPs: both recompute through a dense f32 version and
    differ in summation order alone: rtol 2e-4 / atol 2e-5 on values of
    magnitude ~1 (1e-4 where the HVP chains two such products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu import ops as jops
from ggmlsharp_tpu.kernels import flash as jflash
from ggmlsharp_tpu_torch import ops
from ggmlsharp_tpu_torch.kernels.flash import (
    _cached_ref, _padded_d, _uncached_ref, flash_attention,
    flash_attention_cached,
)

TOL = dict(rtol=2e-4, atol=2e-5)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# --- values ---------------------------------------------------------------------

@pytest.mark.parametrize("lead,sq,sk,D,causal,n_past", [
    ((2, 3), 20, 20, 32, True, 0),    # leading dims, causal from 0
    ((1,), 8, 24, 16, False, 0),      # Sq != Sk, full attention
    ((2,), 8, 24, 16, True, 16),      # static n_past: 16 past keys
    ((3,), 12, 12, 20, True, 0),      # a head dim no instance has (padded)
    ((2, 2), 9, 16, 8, True, 7),      # D 8, the graph example's heads
])
def test_uncached_matches_jax(lead, sq, sk, D, causal, n_past):
    rng = np.random.default_rng(sq * 100 + sk + D)
    q, k, v = (_randn(rng, *lead, sq, D), _randn(rng, *lead, sk, D),
               _randn(rng, *lead, sk, D))
    want = np.asarray(jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        n_past=n_past, block_q=8, block_k=8))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          n_past=n_past)
    assert got.dtype == torch.float32 and got.shape == (*lead, sq, D)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the graph op's CPU route (_flash_dense) computes the same function
    dense = ops.flash_attn(*map(torch.from_numpy, (q, k, v)), masked=causal,
                           n_past=n_past)
    np.testing.assert_allclose(dense.numpy(), want, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_uncached_softcap_matches_jax_kernel(causal):
    """softcap on the uncached function: JAX's _flash_bhsd (the TPU kernel
    itself; its uncached entry passes no softcap) at block multiples."""
    rng = np.random.default_rng(7 + causal)
    BH, S, D, cap = 3, 16, 32, 1.5
    q, k, v = (_randn(rng, BH, S, D) * 3, _randn(rng, BH, S, D) * 3,
               _randn(rng, BH, S, D))
    want = np.asarray(jflash._flash_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, 2, causal,
        D ** -0.5, 8, 8, S, softcap=cap))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          n_past=2, softcap=cap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            n_past=2)
    assert not np.allclose(plain.numpy(), want, **TOL)  # the cap matters


@pytest.mark.parametrize("B,Hq,Hkv,S,T,D,npast,cap", [
    (1, 4, 2, 12, 24, 32, [0], 30.0),      # GQA, the smoke's cap
    (2, 4, 4, 10, 32, 16, [5, 20], 1.0),   # a cap that bends every score
    (1, 2, 1, 9, 40, 24, [13], 2.0),       # a padded head dim
])
def test_cached_softcap_matches_jax(B, Hq, Hkv, S, T, D, npast, cap):
    rng = np.random.default_rng(B + S + T)
    q, k, v = (_randn(rng, B, Hq, S, D) * 2, _randn(rng, B, Hkv, T, D) * 2,
               _randn(rng, B, Hkv, T, D))
    np_arr = np.asarray(npast, np.int32)
    want = np.asarray(jflash.flash_attention_cached(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(np_arr),
        softcap=cap, block_q=8, block_k=8))
    got = flash_attention_cached(*map(torch.from_numpy, (q, k, v, np_arr)),
                                 softcap=cap)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("entry", ["uncached", "cached"])
def test_f16_inputs_against_jax_bf16_cast(entry):
    """f16 q/k/v: the port computes on the f16 values; JAX rounds them to
    bf16 first. The difference stays within 2^-8 * max|v|, and the port
    equals its own f32 function of the f16 values exactly."""
    rng = np.random.default_rng(21)
    q, k, v = (_randn(rng, 2, 4, 16, 32).astype(np.float16) for _ in range(3))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if entry == "uncached":
        want = np.asarray(jflash.flash_attention(jq, jk, jv, block_q=8,
                                                 block_k=8)).astype(np.float32)
        got = flash_attention(tq, tk, tv)
        assert got.dtype == torch.float16
        exact = _uncached_ref(tq, tk, tv, True, 0, 32 ** -0.5).half()
    else:
        npast = np.array([0, 3], np.int32)
        want = np.asarray(jflash.flash_attention_cached(
            jq, jk, jv, jnp.asarray(npast), block_q=8, block_k=8))
        got = flash_attention_cached(tq, tk, tv, torch.from_numpy(npast))
        exact = _cached_ref(tq, tk, tv, torch.from_numpy(npast), 32 ** -0.5)
    assert torch.equal(got, exact)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 ** -8 * float(np.abs(v).max()))


def test_head_dims_pad_to_an_instance():
    """Any D <= 256 maps to the next kernel instance; D > 256 raises."""
    assert [_padded_d(d) for d in (1, 8, 32, 33, 64, 100, 128, 200, 256)] \
        == [32, 32, 32, 64, 64, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="256"):
        _padded_d(257)


# --- gradients ------------------------------------------------------------------

def _grads_torch(fn, arrays, w, create=False):
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays]
    out = fn(*xs)
    gs = torch.autograd.grad(out, xs, torch.from_numpy(w),
                             create_graph=create)
    return xs, gs


@pytest.mark.parametrize("entry", ["cached", "uncached_causal", "uncached_full"])
def test_gradients_match_jax_custom_vjp(entry):
    """d(sum(out * w))/d(q, k, v): the port's Function (its backward
    recomputes _cached_ref / _uncached_ref) against jax.grad through
    _flash_cached's and _flash_pallas' custom VJPs."""
    rng = np.random.default_rng(len(entry))
    if entry == "cached":
        B, Hq, Hkv, S, T, D = 2, 4, 2, 12, 20, 16
        arrays = [_randn(rng, B, Hq, S, D), _randn(rng, B, Hkv, T, D),
                  _randn(rng, B, Hkv, T, D)]
        npast = np.array([3, 8], np.int32)
        w = _randn(rng, B, Hq, S, D)
        _, got = _grads_torch(lambda a, b, c: flash_attention_cached(
            a, b, c, torch.from_numpy(npast), softcap=5.0), arrays, w)

        def jf(a, b, c):
            out = jflash.flash_attention_cached(a, b, c, jnp.asarray(npast),
                                                softcap=5.0, block_q=8,
                                                block_k=8)
            return jnp.sum(out * w)
    else:
        causal = entry == "uncached_causal"
        arrays = [_randn(rng, 3, 8, 16), _randn(rng, 3, 16, 16),
                  _randn(rng, 3, 16, 16)]
        w = _randn(rng, 3, 8, 16)
        _, got = _grads_torch(lambda a, b, c: ops.flash_attn(
            a, b, c, masked=causal, n_past=4), arrays, w)
        _, got_fn = _grads_torch(lambda a, b, c: flash_attention(
            a, b, c, causal=causal, n_past=4), arrays, w)
        for g1, g2 in zip(got, got_fn):  # dense op vs the kernel's Function
            np.testing.assert_allclose(g1.numpy(), g2.numpy(), **TOL)

        def jf(a, b, c):
            return jnp.sum(jops.flash_attn(a, b, c, masked=causal, n_past=4,
                                           use_pallas=True) * w)
    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), **TOL)


def test_hvp_matches_jax():
    """A double backward of the cached entry: u · d/dx (grad of sum(out * w))
    against JAX's second derivative of its custom VJP's backward rule,
    jax.vjp of _cached_ref (JAX defines no second reverse pass through a
    pallas_call, so the reference differentiates the rule's own function)."""
    rng = np.random.default_rng(5)
    B, Hq, Hkv, S, T, D = 1, 2, 1, 9, 12, 8
    arrays = [_randn(rng, B, Hq, S, D), _randn(rng, B, Hkv, T, D),
              _randn(rng, B, Hkv, T, D)]
    npast = np.array([2], np.int32)
    w = _randn(rng, B, Hq, S, D)
    us = [_randn(rng, *a.shape) for a in arrays]
    xs, gs = _grads_torch(lambda a, b, c: flash_attention_cached(
        a, b, c, torch.from_numpy(npast)), arrays, w, create=True)
    dot = sum((g * torch.from_numpy(u)).sum() for g, u in zip(gs, us))
    got = torch.autograd.grad(dot, xs)

    def jgrad_dot(a, b, c):
        g = jax.grad(lambda *x: jnp.sum(jflash._cached_ref(
            *x, jnp.asarray(npast), D ** -0.5, 0.0) * w),
            argnums=(0, 1, 2))(a, b, c)
        return sum(jnp.sum(gi * u) for gi, u in zip(g, us))

    want = jax.grad(jgrad_dot, argnums=(0, 1, 2))(*map(jnp.asarray, arrays))
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("S", [4, 12])
def test_cached_attention_softcap_matches_jax(S):
    """models.common.cached_attention(attn_softcap=) against the JAX
    function: S 12 > 8 through the flash entry, S 4 through the grouped
    einsum; GQA n_rep 2 over an f32 head-major cache with 5 rows already
    written."""
    from ggmlsharp_tpu.models import common as jcommon
    from ggmlsharp_tpu.models import kv_cache as jkvc
    from ggmlsharp_tpu_torch.models import common
    from ggmlsharp_tpu_torch.models import kv_cache as kvc

    rng = np.random.default_rng(S)
    B, Hq, Hkv, D, T, cap = 2, 4, 2, 16, 32, 2.0
    q = _randn(rng, B, Hq, S, D) * 2
    kn, vn = _randn(rng, B, Hkv, S, D) * 2, _randn(rng, B, Hkv, S, D)
    old = [_randn(rng, B, Hkv, 5, D) for _ in range(2)]
    pos0 = np.tile(np.arange(5, dtype=np.int32), (B, 1))
    pos = (5 + np.arange(S, dtype=np.int32))[None].repeat(B, 0)
    jc = jkvc.update_layer(jkvc.init_cache(1, B, Hkv, T, D,
                                           dtype=jnp.float32), 0,
                           *map(jnp.asarray, old), jnp.asarray(pos0))
    want, _ = jcommon.cached_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jc, 0,
        jnp.asarray(pos), n_rep=2, attn_softcap=cap, prefix_bound=T)
    tc = kvc.update_layer(kvc.init_cache(1, B, Hkv, T, D, dtype=torch.float32,
                                         device="cpu"), 0,
                          *map(torch.from_numpy, old), torch.from_numpy(pos0))
    got, _ = common.cached_attention(
        *map(torch.from_numpy, (q, kn, vn)), tc, 0, torch.from_numpy(pos),
        n_rep=2, attn_softcap=cap, prefix_bound=T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
