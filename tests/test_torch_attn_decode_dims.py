"""The domain of the port's decode attention kernel (kernels.attn_decode):
every head dim and cache width the JAX package's flash_decode_flat accepts
at D 32, 64, 128 and 256 passes the wrapper's card-side check ``_check``,
and at D 32 over a 192-lane cache (the perplexity chain's 4L/192E/6-head
model) the port's plain version equals the JAX kernel in interpret mode.

``_check`` runs only for CUDA tensors (a CPU tensor takes ``_decode_ref``),
so these tests call it directly on CPU tensors: it reads shapes, dtypes and
strides, never the data. JAX's acceptance is its trace (``jax.eval_shape``:
``pick_chunk``'s VMEM budgets are its only refusals).

Tolerances are those of tests/test_torch_attn_decode.py: 2e-5 in mm_dot
"f32" (f32 throughout, summation order and online vs dense softmax), 2e-2
in "bf16" (a softmax weight may round to the neighbouring bf16 value
against a different maximum on either side).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.kernels import config as jkcfg
from ggmlsharp_tpu.kernels.attn_decode import flash_decode_flat as jax_decode
from ggmlsharp_tpu_torch.kernels import _build
from ggmlsharp_tpu_torch.kernels import attn_decode as ad

DOMAIN = [(D, E) for D in (32, 64, 128, 256) for E in (128, 192, 256, 512)
          if E % D == 0]


def _shapes(B, Hq, Hkv, D, T):
    E = Hkv * D
    return {"q": (B, Hq, D), "row": (B, E), "cache": (B, T, E),
            "scale": (B, T, Hkv), "npast": (B,)}


def _jax_accepts(B, Hq, Hkv, D, T, cache):
    s = _shapes(B, Hq, Hkv, D, T)
    f32 = lambda k: jax.ShapeDtypeStruct(s[k], jnp.float32)
    kv = jnp.int8 if cache == "int8" else jnp.bfloat16
    kc = jax.ShapeDtypeStruct(s["cache"], kv)
    npast = jax.ShapeDtypeStruct(s["npast"], jnp.int32)
    if cache == "int8":
        out = jax.eval_shape(
            lambda q, kn, vn, k, v, n, ks, vs: jax_decode(
                q, kn, vn, k, v, n, Hkv, D, k_scale=ks, v_scale=vs),
            f32("q"), f32("row"), f32("row"), kc, kc, npast, f32("scale"),
            f32("scale"))
    else:
        out = jax.eval_shape(
            lambda q, kn, vn, k, v, n: jax_decode(q, kn, vn, k, v, n, Hkv, D),
            f32("q"), f32("row"), f32("row"), kc, kc, npast)
    return out.shape


def _port_check(B, Hq, Hkv, D, T, cache):
    s = _shapes(B, Hq, Hkv, D, T)
    kv = torch.int8 if cache == "int8" else torch.bfloat16
    kc = torch.zeros(s["cache"], dtype=kv)
    sc = torch.ones(s["scale"]) if cache == "int8" else None
    return ad._check(torch.zeros(s["q"]), torch.zeros(s["row"]),
                     torch.zeros(s["row"]), kc, kc,
                     torch.zeros(s["npast"], dtype=torch.int32), Hkv, D, sc,
                     sc)


@pytest.mark.parametrize("cache", ["bf16", "int8"])
@pytest.mark.parametrize("D,E", DOMAIN, ids=[f"D{d}-E{e}" for d, e in DOMAIN])
def test_check_accepts_what_jax_accepts(D, E, cache):
    """MHA and GQA (n_rep 2) at each (D, E_kv): where JAX traces, the
    port's card-side check passes and names the cache kind and its batch
    stride."""
    B, T, Hkv = 2, 64, E // D
    for n_rep in (1, 2):
        assert _jax_accepts(B, n_rep * Hkv, Hkv, D, T, cache) == \
            (B, n_rep * Hkv, D)
        assert _port_check(B, n_rep * Hkv, Hkv, D, T, cache) == \
            (int(cache == "int8"), T * E)


def test_check_takes_any_n_rep():
    """JAX has no cap on the query heads a KV head serves; neither has the
    port's kernel (query rows in passes of four)."""
    for n_rep in (3, 33, 48):
        assert _jax_accepts(1, n_rep, 1, 64, 32, "int8") == (1, n_rep, 64)
        assert _port_check(1, n_rep, 1, 64, 32, "int8") == (1, 32 * 64)


def test_check_names_a_head_dim_without_an_instance():
    with pytest.raises(ValueError, match="head_dim 48"):
        _port_check(1, 4, 4, 48, 16, "bf16")
    with pytest.raises(ValueError, match="head_dim 16"):
        _port_check(1, 8, 8, 16, 16, "int8")


def test_every_head_dim_has_an_instance():
    """Each of HEAD_DIMS is dispatched by the source's launch_d."""
    with open(os.path.join(_build.CSRC, "attn_decode.cu")) as f:
        text = f.read()
    body = text[text.index("int launch_d("):]
    body = body[:body.index("\n}\n")]
    assert sorted(int(d) for d in re.findall(r"D == (\d+)", body)) == \
        sorted(ad.HEAD_DIMS)
    assert "n_rep > 32" not in text


def _inputs(B, Hq, Hkv, D, T, npasts, cache, seed):
    rng = np.random.default_rng(seed)
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


@pytest.mark.parametrize("mode,tol", [("f32", 2e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("cache", ["bf16", "int8"])
def test_d32_e192_matches_jax(cache, mode, tol):
    """The chain model's decode shape, cut to 4 slots: D 32, 6 KV heads
    (E_kv 192), T 128, per-slot npasts from 0 to past the view."""
    B, Hq, Hkv, D, T = 4, 6, 6, 32, 128
    q, kn, vn, kc, vc, ks, vs, npast = _inputs(B, Hq, Hkv, D, T,
                                               [0, 17, 127, 200], cache, 7)
    jconv = (lambda x: jnp.asarray(x).astype(jnp.bfloat16)) \
        if cache == "bf16" else jnp.asarray
    tconv = (lambda x: torch.from_numpy(x).to(torch.bfloat16)) \
        if cache == "bf16" else torch.from_numpy
    jsc = {} if ks is None else {"k_scale": jnp.asarray(ks),
                                 "v_scale": jnp.asarray(vs)}
    tsc = {} if ks is None else {"k_scale": torch.from_numpy(ks),
                                 "v_scale": torch.from_numpy(vs)}
    prev = jkcfg.mm_dot_mode()
    jkcfg.set_mm_dot(mode)
    try:
        want = np.asarray(jax_decode(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jconv(kc),
            jconv(vc), jnp.asarray(npast), Hkv, D, **jsc))
    finally:
        jkcfg.set_mm_dot(prev)
    args = (torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
            tconv(kc), tconv(vc), torch.from_numpy(npast), Hkv, D)
    got = ad.flash_decode_flat(*args, mode=mode, **tsc).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # the split algorithm the kernel runs, at the splits it would take
    split = ad._decode_ref_split(*args, splits=ad.decode_splits(B * Hkv, T),
                                 **tsc).numpy()
    if mode == "f32":
        np.testing.assert_allclose(split, want, rtol=tol, atol=tol)
    assert ad._check(*args[:6], Hkv, D, tsc.get("k_scale"),
                     tsc.get("v_scale"))[0] == int(cache == "int8")
