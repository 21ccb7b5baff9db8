"""Port attention and the small ops of the llama path against the JAX package.

Flash: the port's plain version (what the wrapper runs on a CPU tensor)
against JAX kernels.flash.flash_attention_cached, which runs its Pallas
kernel in interpret mode on the CPU. rtol 2e-4 / atol 2e-5 as in
tests/test_kernels.py: online vs dense softmax, f32 summation order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu import ops as jops
from ggmlsharp_tpu.kernels.flash import flash_attention_cached as jflash
from ggmlsharp_tpu.models.common import _einsum_attention as jeinsum
from ggmlsharp_tpu_torch import ops
from ggmlsharp_tpu_torch.kernels.flash import _cached_ref, flash_attention_cached
from ggmlsharp_tpu_torch.models.common import _einsum_attention


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("B,Hq,Hkv,S,T,D,npast,block", [
    (1, 4, 4, 16, 32, 32, [0], 8),        # MHA, prefill from 0
    (1, 4, 2, 12, 24, 32, [0], 8),        # GQA n_rep 2, S not a block multiple
    (2, 4, 2, 10, 48, 64, [5, 30], 8),    # GQA, per-batch npast > 0
    (1, 2, 1, 9, 40, 16, [13], 16),       # n_rep 2, S < block, ragged T
])
def test_plain_flash_matches_jax(B, Hq, Hkv, S, T, D, npast, block):
    rng = np.random.default_rng(B * 1000 + S * 10 + T)
    q, k, v = (_randn(rng, B, Hq, S, D), _randn(rng, B, Hkv, T, D),
               _randn(rng, B, Hkv, T, D))
    np_arr = np.asarray(npast, np.int32)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(np_arr), block_q=block,
                             block_k=block))
    got = flash_attention_cached(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(np_arr))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)


def test_flash_bf16_cache_prefix_view():
    """A bf16 cache read through a prefix view along T gives the same result
    as its f32 copy: the cast is exact."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_randn(rng, 1, 4, 12, 32))
    kc = torch.from_numpy(_randn(rng, 1, 2, 64, 32)).to(torch.bfloat16)
    vc = torch.from_numpy(_randn(rng, 1, 2, 64, 32)).to(torch.bfloat16)
    npast = torch.tensor([4], dtype=torch.int32)
    got = flash_attention_cached(q, kc[:, :, :20], vc[:, :, :20], npast)
    want = _cached_ref(q, kc[:, :, :20].float(), vc[:, :, :20].float(), npast,
                       1.0 / 32 ** 0.5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_rep,S", [(1, 1), (2, 1), (2, 4)])
def test_einsum_attention_matches_jax(n_rep, S):
    """Decode-side attention (S <= 8): grouped einsum; f32 summation order."""
    rng = np.random.default_rng(n_rep * 10 + S)
    B, Hkv, t, D = 2, 2, 24, 16
    q = _randn(rng, B, Hkv * n_rep, S, D)
    k, v = _randn(rng, B, Hkv, t, D), _randn(rng, B, Hkv, t, D)
    pos = (np.array([[7], [15]]) + np.arange(S)[None]).astype(np.int32)
    want = np.asarray(jeinsum(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), n_rep, 0.0))
    got = _einsum_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), torch.from_numpy(pos), n_rep)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("mode", [0, 2])
def test_rope_matches_jax(mode):
    """Per-batch positions over [B, H, S, D]. pow/sin/cos come from two libm
    implementations: a few ulp at these angles, hence atol 1e-5."""
    rng = np.random.default_rng(mode)
    x = _randn(rng, 2, 3, 5, 16)
    pos = np.array([[0, 1, 2, 3, 4], [40, 41, 42, 43, 44]], np.int32)
    want = np.stack([np.asarray(jops.rope(jnp.asarray(x[b]),
                                          jnp.asarray(pos[b]), mode=mode))
                     for b in range(2)])
    got = ops.rope(torch.from_numpy(x), torch.from_numpy(pos), mode=mode)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rms_norm_and_silu_match_jax():
    rng = np.random.default_rng(9)
    x = _randn(rng, 3, 256) * 3
    np.testing.assert_allclose(
        ops.rms_norm(torch.from_numpy(x)).numpy(),
        np.asarray(jops.rms_norm(jnp.asarray(x), eps=1e-6)),
        rtol=2e-6, atol=2e-6)  # mean's summation order
    np.testing.assert_allclose(ops.silu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.jit(jops.silu)(jnp.asarray(x))),
                               rtol=2e-6, atol=2e-6)  # libm exp


def test_get_rows_q4_0_matches_jax():
    """A quantized table gathers blocks, then dequantizes: bit-exact."""
    from ggmlsharp_tpu import GType as JGType
    from ggmlsharp_tpu import quantize as jquantize
    from ggmlsharp_tpu.io.gguf import qtensor_to_wire
    from ggmlsharp_tpu_torch import GType
    from ggmlsharp_tpu_torch.quant.formats import from_wire

    table = _randn(np.random.default_rng(4), 64, 256)
    jt = jquantize(jnp.asarray(table), JGType.Q4_0)
    tt = from_wire(GType.Q4_0, qtensor_to_wire(jt)[1], (64, 256),
                   device="cpu")
    ids = np.array([[3, 63, 0, 3]], np.int32)
    want = np.asarray(jops.get_rows(jt, jnp.asarray(ids)))
    got = ops.get_rows(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
