"""``mm_dot`` in the port (kernels.config): the plain versions of the
kernels whose JAX counterparts take ``mode`` (the dequant-matmuls, TPU
kernels 1, 4, 5 and 6, and decode attention, kernel 3), and the fused GELU
MLP (kernel 8), against the JAX package with ``set_mm_dot`` set to the same
mode on both sides, at 1 and several activation rows.

  * "f32": both compute the exact function; they differ in f32 summation
    order: rtol 1e-5 / atol 1e-4, the bar of test_torch_matmul_formats.py.
  * "bf16": the port rounds f32 x to bf16 once and accumulates in f32. The
    JAX kernels feed the matrix unit at DEFAULT precision, which on the
    CPU multiplies f32 operands exactly: the two differ by the rounding of
    x, noise that grows as 2^-8·|x·w|·sqrt(K) (ggmlsharp_tpu/kernels/
    matmul_q.py:387-394), so the bar is that, with |x·w| the largest
    product term of the output. The port's
    "bf16" function itself is checked exactly: its "f32" function of x
    rounded to bf16.

Kernel 3's modes are held against JAX in test_torch_attn_decode.py; here,
that the port's two modes are two functions and that the mode reaches the
plain version through the dispatch.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu.kernels import config as jkcfg
from ggmlsharp_tpu.kernels import matmul_q as jmq
from ggmlsharp_tpu.kernels.mlp_fused import flash_ff_q8 as jflash_ff_q8
from ggmlsharp_tpu.kernels.mlp_fused import fuse_mlp_q8
from ggmlsharp_tpu.quant.formats import to_storage_order, to_swar
from ggmlsharp_tpu_torch import GType, dequantize
from ggmlsharp_tpu_torch.kernels import attn_decode as ad
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.kernels.matmul_q import mul_mat_q_fused
from ggmlsharp_tpu_torch.kernels.mlp_fused import _ff_ref, flash_ff_q8
from ggmlsharp_tpu_torch.ops import mul_mat_q
from ggmlsharp_tpu_torch.ops.matmul import round_bf16
from test_torch_matmul_formats import K, N, _pair, _x

ROWS = (1, 3, 16)
MODES = ("f32", "bf16")


@pytest.fixture
def modes(monkeypatch):
    """Set mm_dot on both sides for one test."""
    def set_both(mode):
        monkeypatch.setattr(jkcfg, "_mm_dot", mode)
        monkeypatch.setattr(kcfg, "_mm_dot", mode)
    return set_both


def _noise_bar(x, w):
    """2^-8·|x·w|·sqrt(K): |x·w| the largest product term of each output
    (x [B, K], w dequantized [N, K])."""
    terms = x.abs()[:, None, :] * w.abs()[None]
    return 2.0 ** -8 * terms.amax(-1) * x.shape[-1] ** 0.5


def _hold(got, want, x, tw, mode):
    assert got.dtype == torch.float32
    want = torch.from_numpy(np.array(want))
    if mode == "f32":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-4)
        return
    bar = _noise_bar(x, dequantize(tw, fused_scales=True))
    assert bool(((got - want).abs() <= bar).all()), \
        float(((got - want).abs() / bar).max())


def _port(tw, x, mode):
    """The dispatch the models take, configured mode, on the CPU."""
    kcfg.set_mm_dot(mode)
    return mul_mat_q_fused(tw, x, quantize_acts=False)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1", "Q4_2", "Q4_3", "Q5_0",
                                 "Q5_1", "Q8_0", "Q4_K", "Q6_K"])
def test_plain_matches_tpu_kernel_6_in_each_mode(modes, fmt, rows, mode):
    modes(mode)
    jw, tw = _pair(fmt)
    x = _x(rows)
    _, keys, bs = jmq._DEQUANT_TILE[jw.gtype]
    want = jmq._call_kernel(to_storage_order(jnp.asarray(x), bs),
                            dict(jw.planes), jw.gtype, N, K, keys, mode)
    xt = torch.from_numpy(x)
    _hold(_port(tw, xt, mode), want, xt, tw, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1", "Q4_K"])
def test_plain_matches_tpu_kernel_5_in_each_mode(modes, fmt, rows, mode):
    modes(mode)
    jw, tw = _pair(fmt)
    x = _x(rows)
    want = jmq._call_kernel_planes(to_storage_order(jnp.asarray(x), 32),
                                   dict(jw.planes), jw.gtype, N, K, mode,
                                   mode == "bf16")
    xt = torch.from_numpy(x)
    _hold(_port(tw, xt, mode), want, xt, tw, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1", "Q4_K", "Q5_0", "Q5_1",
                                 "Q6_K", "Q8_0"])
def test_plain_matches_tpu_kernels_1_and_4_in_each_mode(modes, fmt, rows,
                                                         mode):
    """mul_mat_swar reads the JAX mode itself: kernel 1 (_call_kernel_swar)
    and, for Q8_0, kernel 4 (_call_kernel_swar_q8)."""
    modes(mode)
    jw, tw = _pair(fmt)
    x = _x(rows)
    want = jmq.mul_mat_swar(to_swar(jw), jnp.asarray(x), quantize_acts=False)
    xt = torch.from_numpy(x)
    _hold(_port(tw, xt, mode), want, xt, tw, mode)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("fmt", ["Q4_0", "Q8_0", "Q4_1", "Q4_K", "Q6_K"])
def test_bf16_is_the_f32_function_of_rounded_x(fmt, rows):
    """The two modes are two functions: "bf16" is exactly "f32" of x
    rounded to bf16 (and differs from "f32" of x); the Q8 round trip is
    exact in both."""
    _, tw = _pair(fmt)
    x = torch.from_numpy(_x(rows))
    got = mul_mat_q_fused(tw, x, quantize_acts=False, mode="bf16")
    assert torch.equal(got, mul_mat_q(tw, round_bf16(x), quantize_acts=False))
    assert not torch.equal(got, mul_mat_q_fused(tw, x, quantize_acts=False,
                                                mode="f32"))
    assert torch.equal(mul_mat_q_fused(tw, x, mode="bf16"),
                       mul_mat_q_fused(tw, x, mode="f32"))


def test_unknown_mode_is_refused():
    _, tw = _pair("Q4_0")
    with pytest.raises(ValueError):
        mul_mat_q_fused(tw, torch.from_numpy(_x(2)), quantize_acts=False,
                        mode="tf32")
    with pytest.raises(ValueError):
        kcfg.set_mm_dot("f16")


def test_decode_attention_modes_are_two_functions(monkeypatch):
    """Kernel 3's plain version: "bf16" rounds the cache rows' query and
    softmax weights (its own function, not "f32"'s); the dispatch passes the
    configured mode."""
    rng = np.random.default_rng(4)
    B, Hq, Hkv, D, T = 2, 4, 2, 64, 40
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    q, kn, vn = f(B, Hq, D), f(B, Hkv * D), f(B, Hkv * D)
    kc, vc = (f(B, T, Hkv * D).to(torch.bfloat16) for _ in range(2))
    npast = torch.tensor([17, 40])
    args = (q, kn, vn, kc, vc, npast, Hkv, D)
    a, b = (ad._decode_ref(*args, mode=m) for m in MODES)
    assert not torch.equal(a, b)
    torch.testing.assert_close(a, b, rtol=2e-2, atol=2e-2)
    for mode, want in zip(MODES, (a, b)):
        monkeypatch.setattr(kcfg, "_mm_dot", mode)
        assert torch.equal(ad.flash_decode_flat(*args), want)


def _mlp_pair(E, F, seed):
    """A JAX Q8_0 pair and biases, and the port's copies (wire bytes)."""
    from ggmlsharp_tpu import GType as JGType
    from ggmlsharp_tpu import quantize as jquantize
    from ggmlsharp_tpu.io.gguf import qtensor_to_wire
    from ggmlsharp_tpu_torch.quant.formats import from_wire

    rng = np.random.default_rng(seed)
    w1 = (rng.standard_normal((F, E)) * 0.05).astype(np.float32)
    w2 = (rng.standard_normal((E, F)) * 0.05).astype(np.float32)
    b1 = (rng.standard_normal(F) * 0.05).astype(np.float32)
    b2 = (rng.standard_normal(E) * 0.05).astype(np.float32)
    j1, j2 = (jquantize(jnp.asarray(w), JGType.Q8_0) for w in (w1, w2))
    t1, t2 = (from_wire(GType.Q8_0, qtensor_to_wire(j)[1], j.shape,
                        device="cpu") for j in (j1, j2))
    return (j1, b1, j2, b2), (t1, torch.from_numpy(b1), t2,
                              torch.from_numpy(b2))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rows", [1, 2, 16, 64])
def test_fused_gelu_mlp_plain_in_each_mode(monkeypatch, mode, rows):
    """Kernel 8's plain version against the JAX kernel (no mode of its own:
    DEFAULT dots, f32 on the CPU): "f32" at the bar of test_torch_gpt2.py
    (5e-5), "bf16" (x rounded, h exact) within the noise bar of W1's
    products carried through gelu (slope <= 1.13) and W2 (its column sums of
    |w|), plus the f32 bar."""
    (j1, jb1, j2, jb2), (t1, tb1, t2, tb2) = _mlp_pair(256, 1024, rows)
    x = np.random.default_rng(rows).standard_normal((rows, 256)).astype(
        np.float32)
    fused = fuse_mlp_q8(j1, jnp.asarray(jb1), j2, jnp.asarray(jb2))
    want = torch.from_numpy(np.array(jflash_ff_q8(
        fused, jnp.asarray(x), quantize_acts=False)))
    monkeypatch.setattr(kcfg, "_mm_dot", mode)
    got = flash_ff_q8(t1, tb1, t2, tb2, torch.from_numpy(x),
                      quantize_acts=False)
    xt = torch.from_numpy(x)
    assert torch.equal(got, _ff_ref(t1, tb1, t2, tb2, xt, False, mode))
    bar = torch.full_like(got, 5e-5) + 5e-5 * want.abs()
    if mode == "bf16":
        h_bar = _noise_bar(xt, dequantize(t1))  # [rows, F]
        bar = bar + 1.13 * h_bar @ dequantize(t2).abs().T
    assert bool(((got - want).abs() <= bar).all())
