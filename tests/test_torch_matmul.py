"""Port quantized matmul (plain version) against the JAX reference
ggmlsharp_tpu.ops.matmul.mul_mat_q. Both dequantize the same weights to the
same f32 values and (with quantize_acts) round the activations through the
same Q8_0 blocks bit for bit; the only difference is the f32 summation
order of the dot, hence rtol/atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu import GType as JGType
from ggmlsharp_tpu import quantize as jquantize
from ggmlsharp_tpu.io.gguf import qtensor_to_wire
from ggmlsharp_tpu.ops.matmul import mul_mat_q as jmul_mat_q
from ggmlsharp_tpu_torch import GType
from ggmlsharp_tpu_torch.kernels import config as kcfg
from ggmlsharp_tpu_torch.kernels.matmul_q import mul_mat_q_fused
from ggmlsharp_tpu_torch.ops import mul_mat, mul_mat_f, mul_mat_q
from ggmlsharp_tpu_torch.quant.formats import from_wire


@pytest.fixture(autouse=True)
def _port_mm_dot_f32(monkeypatch):
    """The port in mm_dot "f32", the function these tests hold against the
    JAX package: its matmuls multiply f32 operands exactly on the CPU in
    either of its modes (DEFAULT precision is f32 there). The port's "bf16"
    function is held against JAX in test_torch_mm_dot.py."""
    monkeypatch.setattr(kcfg, "_mm_dot", "f32")


def _pair(n, k, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, k)).astype(np.float32) * 0.05
    jw = jquantize(jnp.asarray(w), JGType.Q4_0)
    g, wire = qtensor_to_wire(jw)
    return jw, from_wire(GType(int(g)), wire, (n, k), device="cpu")


@pytest.mark.parametrize("quantize_acts", [True, False])
@pytest.mark.parametrize("rows", [1, 3, 16])
@pytest.mark.parametrize("n,k", [(512, 256), (256, 1024)])
def test_plain_q4_0_matmul_matches_jax(rows, n, k, quantize_acts):
    jw, tw = _pair(n, k, seed=rows * 7 + n + k)
    x = np.random.default_rng(rows).standard_normal((rows, k)).astype(
        np.float32)
    want = np.asarray(jmul_mat_q(jw, jnp.asarray(x),
                                 quantize_acts=quantize_acts))
    got = mul_mat(tw, torch.from_numpy(x), quantize_acts=quantize_acts)
    assert got.dtype == torch.float32 and tuple(got.shape) == (rows, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_is_the_plain_version():
    """On a CPU tensor the kernel wrapper runs mul_mat_q, leading dims kept."""
    _, tw = _pair(256, 256, seed=11)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, 256)).astype(np.float32))
    got = mul_mat_q_fused(tw, x)
    assert tuple(got.shape) == (2, 3, 256)
    assert torch.equal(got, mul_mat_q(tw, x))


def test_mul_mat_f_promotes_like_jax():
    a = torch.ones(4, 8, dtype=torch.bfloat16)
    b = torch.ones(2, 8, dtype=torch.float32)
    out = mul_mat_f(a, b)
    assert out.dtype == torch.float32 and float(out[0, 0]) == 8.0
