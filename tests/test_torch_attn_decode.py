"""The port's flat-cache decode attention (kernels.attn_decode, its plain
version on the CPU) against the JAX package's flash_decode_flat, which runs
its Pallas kernel in interpret mode here.

The shapes are those of tests/test_attn_decode.py (MHA, GQA with n_rep 2
and 4, T 1024 with npast 600 over several JAX chunks, batched per-slot
npasts), over bf16 and INT8 caches; the inputs are made with numpy and
handed to both packages.

Both packages run in the same mm_dot mode. Tolerances:
  * "f32" (set_mm_dot("f32") on both sides): both compute in f32 and
    differ only in summation order and the online vs dense softmax: 2e-5;
  * "bf16" (the default): both feed the score products the query rounded
    to bf16 and round each softmax weight to bf16 for P.V, but against
    different maxima (the JAX kernel's running one, chunk by chunk; the
    port's integer base-2 one), so a weight may round to a neighbouring
    bf16 value on either side: a 2^-8 relative error on a convex
    combination of values of magnitude ~1: 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.kernels import config as jkcfg
from ggmlsharp_tpu.kernels.attn_decode import flash_decode_flat as jax_decode
from ggmlsharp_tpu_torch.kernels import attn_decode as ad

SHAPES = [  # B, Hq, Hkv, D, T, npasts (tests/test_attn_decode.py:36-42)
    (1, 4, 4, 64, 64, [5]),
    (1, 4, 2, 64, 64, [0]),
    (1, 8, 2, 32, 128, [63]),
    (1, 4, 2, 64, 1024, [600]),
    (4, 4, 2, 64, 128, [5, 0, 99, 127]),
]


def _inputs(B, Hq, Hkv, D, T, npasts, cache):
    """numpy inputs: q, fresh rows, and the cache as (k, v, ks, vs) with
    ks/vs None for bf16 (the bf16 values held as f32, exact)."""
    rng = np.random.default_rng(Hq * 100 + T + B)
    E = Hkv * D
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kf = rng.standard_normal((B, T, E)).astype(np.float32)
    vf = rng.standard_normal((B, T, E)).astype(np.float32)
    kn = rng.standard_normal((B, E)).astype(np.float32)
    vn = rng.standard_normal((B, E)).astype(np.float32)
    npast = np.asarray(npasts, np.int32)
    if cache == "bf16":
        bf = lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16),
                                  np.float32)
        return q, kn, vn, bf(kf), bf(vf), None, None, npast

    def quant(rows):
        rh = rows.reshape(B, T, Hkv, D)
        s = (np.abs(rh).max(-1) / 127.0).astype(np.float32)
        qv = np.clip(np.round(rh / s[..., None]), -127, 127).astype(np.int8)
        return qv.reshape(B, T, E), s

    kq, ks = quant(kf)
    vq, vs = quant(vf)
    return q, kn, vn, kq, vq, ks, vs, npast


def _jax(inp, Hkv, D, cache):
    q, kn, vn, kc, vc, ks, vs, npast = inp
    conv = (lambda x: jnp.asarray(x).astype(jnp.bfloat16)) \
        if cache == "bf16" else jnp.asarray
    scales = {} if ks is None else {"k_scale": jnp.asarray(ks),
                                    "v_scale": jnp.asarray(vs)}
    return np.asarray(jax_decode(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), conv(kc), conv(vc),
        jnp.asarray(npast), Hkv, D, **scales))


def _port(inp, Hkv, D, cache, mode):
    q, kn, vn, kc, vc, ks, vs, npast = inp
    conv = (lambda x: torch.from_numpy(x).to(torch.bfloat16)) \
        if cache == "bf16" else torch.from_numpy
    scales = {} if ks is None else {"k_scale": torch.from_numpy(ks),
                                    "v_scale": torch.from_numpy(vs)}
    return ad.flash_decode_flat(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        conv(kc), conv(vc), torch.from_numpy(npast), Hkv, D, mode=mode,
        **scales).numpy()


@pytest.mark.parametrize("mode,tol", [("f32", 2e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("B,Hq,Hkv,D,T,npasts", SHAPES,
                         ids=[f"B{s[0]}-Hq{s[1]}-Hkv{s[2]}-D{s[3]}-T{s[4]}"
                              for s in SHAPES])
def test_decode_matches_jax(B, Hq, Hkv, D, T, npasts, cache, mode, tol):
    inp = _inputs(B, Hq, Hkv, D, T, npasts, cache)
    prev = jkcfg.mm_dot_mode()
    jkcfg.set_mm_dot(mode)
    try:
        want = _jax(inp, Hkv, D, cache)
    finally:
        jkcfg.set_mm_dot(prev)
    got = _port(inp, Hkv, D, cache, mode)
    assert got.shape == (B, Hq, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("mode,rtol", [("f32", 0.0), ("bf16", 2.0 ** -23)])
def test_fresh_row_is_attended_unquantized(mode, rtol):
    """npast = 0: the output is the fresh V row itself, whatever the cache
    holds; the stale cache row npast is never read. In "f32" bit for bit;
    in "bf16" the row's base-2 weight p multiplies it and the sum p divides
    it again (p·v / p): within an ulp."""
    B, Hq, Hkv, D, T = 2, 4, 2, 64, 16
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((B, Hq, D)).astype(np.float32))
    kn = torch.from_numpy(rng.standard_normal((B, Hkv * D)).astype(np.float32))
    vn = torch.from_numpy(rng.standard_normal((B, Hkv * D)).astype(np.float32))
    kc = torch.full((B, T, Hkv * D), 100, dtype=torch.int8)
    ks = torch.ones((B, T, Hkv))
    out = ad.flash_decode_flat(q, kn, vn, kc, kc, torch.tensor([0, 0]), Hkv,
                               D, k_scale=ks, v_scale=ks, mode=mode)
    want = vn.reshape(B, Hkv, 1, D).expand(B, Hkv, Hq // Hkv, D)
    torch.testing.assert_close(out, want.reshape(B, Hq, D), rtol=rtol,
                               atol=0)


def test_npast_past_the_prefix_attends_every_row():
    """npast >= T (a prefix view shorter than the slot's length): the plain
    version attends all T cache rows and the fresh row, the kernel's rule:
    the answer of a one-row-longer view at npast T, whose stale row T is
    masked."""
    B, Hq, Hkv, D, T = 2, 4, 2, 64, 16
    rng = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, kn, vn = f(B, Hq, D), f(B, Hkv * D), f(B, Hkv * D)
    kc, vc = (f(B, T + 1, Hkv * D).to(torch.bfloat16) for _ in range(2))
    out = ad.flash_decode_flat(q, kn, vn, kc[:, :T], vc[:, :T],
                               torch.tensor([T, T + 5]), Hkv, D)
    want = ad.flash_decode_flat(q, kn, vn, kc, vc, torch.tensor([T, T]),
                                Hkv, D)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)


def test_wrapper_checks_card_inputs():
    """The kernel's input checks run before any launch: an f32 cache, a
    bf16 cache with scales, or rows that are not contiguous, are
    refused."""
    B, Hq, Hkv, D, T = 1, 4, 4, 64, 8
    q = torch.zeros((B, Hq, D))
    row = torch.zeros((B, Hkv * D))
    kc = torch.zeros((B, T, Hkv * D), dtype=torch.bfloat16)
    s = torch.ones((B, T, Hkv))
    npast = torch.zeros((B,), dtype=torch.int32)
    with pytest.raises(ValueError, match="scale"):
        ad._check(q, row, row, kc, kc, npast, Hkv, D, s, s)
    wide = torch.zeros((B, T, 2 * Hkv * D), dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="strides"):
        ad._check(q, row, row, wide, wide, npast, Hkv, D, None, None)
    f32 = kc.float()
    with pytest.raises(TypeError, match="bf16 or int8"):
        ad.flash_decode_flat(q, row, row, f32, f32, npast, Hkv, D)
    assert ad._check(q, row, row, kc, kc, npast, Hkv, D, None, None) == \
        (0, T * Hkv * D)
