"""The plain versions of the port's two new matmul kernels against the JAX
package's TPU kernels, run as the JAX package's own kernel tests run them on
the CPU (Pallas interpret mode, the f32 dot mode):

  * kernel A (``csrc/matmul_q.cu``, plain version ``ops.mul_mat_q``) against
    TPU kernel 6 (``_call_kernel``, every format; the only one for Q4_2 and
    Q4_3), kernel 5 (``_call_kernel_planes``, Q4_0/Q4_1/Q4_K, with and
    without the v2 affine fold) and kernel 1 (``mul_mat_swar``,
    Q4_0/Q4_1/Q4_K/Q5_0/Q5_1/Q6_K), with and without the activation round
    trip. The TPU kernels and the port read the k-quants' fused f16 scales.
    Both sides dequantize to the same f32 values and round the activations
    through the same Q8 blocks (eager JAX and the port quantize bit for
    bit); they differ in f32 summation order: rtol 1e-5 / atol 1e-4, the
    bar of tests/test_kernels.py (measured below 4e-6).
  * kernel B (``csrc/matmul_int_dot.cu``, plain version
    ``kernels.matmul_q._int_dot_ref``) against TPU kernel 7
    (``mul_mat_q_int_dot``) and the C oracle's vec_dot (golden.bin), with
    the oracle test's own tolerance, rtol 1e-6 / atol 1e-6.

Shapes: N 256 (the TPU kernels' tile), K 512; the dequant-matmuls at 3, 5,
8 and 16 activation rows (``ROWS``: the port's multi-row instance takes
them in ragged and whole tiles of 8 rows)."""
import os
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggmlsharp_tpu import GType as JGType
from ggmlsharp_tpu import dequantize as jdequantize
from ggmlsharp_tpu import quantize as jquantize
from ggmlsharp_tpu.io.gguf import qtensor_to_wire
from ggmlsharp_tpu.kernels import config as jkcfg
from ggmlsharp_tpu.kernels import matmul_q as jmq
from ggmlsharp_tpu.ops.matmul import quantize_activations as jquantize_acts
from ggmlsharp_tpu.quant.formats import (
    from_storage_order, to_storage_order, to_swar, unpack_nibbles,
)
from ggmlsharp_tpu_torch import GType, config, quantize
from ggmlsharp_tpu_torch.kernels import matmul_q as mq
from ggmlsharp_tpu_torch.kernels.config import mm_dot_mode
from ggmlsharp_tpu_torch.ops import mul_mat, mul_mat_q
from ggmlsharp_tpu_torch.quant.formats import from_wire

N, K = 256, 512
ROWS = (3, 5, 8, 16)
GOLD = os.path.join(os.path.dirname(__file__), "golden", "golden.bin")


@pytest.fixture(autouse=True)
def _f32_dots(monkeypatch):
    """The JAX kernels' exact mode (Precision.HIGHEST dots)."""
    monkeypatch.setattr(jkcfg, "_mm_dot", "f32")


def _wire(jqt) -> bytes:
    """ggml wire bytes of a JAX QTensor (Q4_2/Q4_3 from its planes: ggml's
    block, f16 d, [f16 m], byte j holding elements j and j + 8)."""
    if jqt.gtype not in (JGType.Q4_2, JGType.Q4_3):
        return qtensor_to_wire(jqt)[1]
    rows, nb = jqt.shape[0], jqt.shape[1] // 16
    v = np.asarray(from_storage_order(unpack_nibbles(jqt["qs"], jqt.shape[1]),
                                      16)).reshape(rows, nb, 16)
    parts = [np.asarray(jqt[p]).reshape(rows, nb, 1).view(np.uint8)
             for p in ("d", "m") if p in jqt.planes]
    parts.append((v[..., :8] | (v[..., 8:] << 4)).astype(np.uint8))
    return np.concatenate(parts, axis=-1).tobytes()


_CACHE = {}


def _pair(fmt):
    """A JAX weight [N, K] of ``fmt`` (one-signed rows, so the min terms
    count) and the port's copy through ggml wire bytes."""
    if fmt not in _CACHE:
        rng = np.random.default_rng(len(fmt) * 7 + 1)
        w = (rng.standard_normal((N, K)) * 0.1 + 0.05).astype(np.float32)
        jw = jquantize(jnp.asarray(w), JGType[fmt])
        _CACHE[fmt] = (jw, from_wire(GType[fmt], _wire(jw), (N, K),
                                     device="cpu"))
    return _CACHE[fmt]


def _x(rows, seed=5):
    return np.random.default_rng(seed).standard_normal((rows, K)).astype(
        np.float32)


def _jax_acts(x, fmt, quantize_acts):
    """The activations the JAX kernels are fed: x, or its Q8 round trip
    through the weight format's vec_dot_type (eager: bit-equal to the
    port's)."""
    xj = jnp.asarray(x)
    return jdequantize(jquantize_acts(xj, JGType[fmt])) if quantize_acts \
        else xj


def _check(got, want):
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("quantize_acts", [False, True])
@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1", "Q4_2", "Q4_3", "Q5_0",
                                 "Q5_1", "Q8_0", "Q4_K", "Q6_K"])
def test_plain_matches_tpu_kernel_6(fmt, quantize_acts, rows):
    jw, tw = _pair(fmt)
    x = _x(rows)
    _, keys, bs = jmq._DEQUANT_TILE[JGType[fmt]]
    want = jmq._call_kernel(to_storage_order(_jax_acts(x, fmt, quantize_acts),
                                             bs), dict(jw.planes),
                            JGType[fmt], N, K, keys, "f32")
    _check(mul_mat_q(tw, torch.from_numpy(x), quantize_acts=quantize_acts),
           want)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("quantize_acts", [False, True])
@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1", "Q4_K"])
def test_plain_matches_tpu_kernel_5(fmt, v2, quantize_acts, rows):
    """v2 folds the affine term through per-position activation sums, as
    kernel A folds the min terms through per-block sums."""
    jw, tw = _pair(fmt)
    x = _x(rows)
    want = jmq._call_kernel_planes(
        to_storage_order(_jax_acts(x, fmt, quantize_acts), 32),
        dict(jw.planes), JGType[fmt], N, K, "f32", v2)
    _check(mul_mat_q(tw, torch.from_numpy(x), quantize_acts=quantize_acts),
           want)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("quantize_acts", [False, True])
@pytest.mark.parametrize("fmt", ["Q4_0", "Q4_1", "Q4_K", "Q5_0", "Q5_1",
                                 "Q6_K"])
def test_plain_matches_tpu_kernel_1(fmt, quantize_acts, rows):
    """The SWAR kernel quantizes the activations itself."""
    jw, tw = _pair(fmt)
    x = _x(rows)
    want = jmq.mul_mat_swar(to_swar(jw), jnp.asarray(x),
                            quantize_acts=quantize_acts)
    _check(mul_mat_q(tw, torch.from_numpy(x), quantize_acts=quantize_acts),
           want)


@pytest.mark.parametrize("fmt", ["Q8_0", "Q4_0", "Q4_1", "Q5_0", "Q5_1"])
def test_int_dot_plain_matches_tpu_kernel_7(fmt):
    jw, tw = _pair(fmt)
    x = _x(1, seed=8)
    want = jmq.mul_mat_q_int_dot(jw, jnp.asarray(x))
    got = mq.int_dot_matmul(tw, torch.from_numpy(x), plain=True)
    assert tuple(got.shape) == (1, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)


@pytest.fixture(scope="module")
def gold():
    sections = {}
    with open(GOLD, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (nl,) = struct.unpack_from("<I", data, off)
        off += 4
        name = data[off:off + nl].decode()
        off += nl
        (pb,) = struct.unpack_from("<I", data, off)
        off += 4
        sections[name] = data[off:off + pb]
        off += pb
    return sections


@pytest.mark.parametrize("name,fmt", [("dot_q4_0_q8_0", "Q4_0"),
                                      ("dot_q8_0_q8_0", "Q8_0"),
                                      ("dot_q4_1_q8_1", "Q4_1"),
                                      ("dot_q5_0_q8_0", "Q5_0"),
                                      ("dot_q5_1_q8_1", "Q5_1")])
def test_int_dot_plain_matches_c_oracle(gold, name, fmt):
    w = from_wire(GType[fmt], gold[f"{fmt.lower()}.wire"], (4, 256),
                  device="cpu")
    x = torch.from_numpy(np.frombuffer(gold["dot.x"], np.float32).copy())
    got = mq.int_dot_matmul(w, x[None], plain=True)[0]
    want = np.frombuffer(gold[f"{name}.y"], np.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_int_dot_switch(monkeypatch):
    """GGML_TPU_INT_DOT=1 (and only "1") sends a one-row matmul with
    quantized activations of an int-dot format to kernel B's route; more
    rows, weight-only matmuls and other formats keep the dequant route."""
    _, q4 = _pair("Q4_0")
    _, qk = _pair("Q4_K")
    x = torch.from_numpy(_x(2, seed=3))
    for value, on in (("1", True), ("true", False), ("0", False)):
        monkeypatch.setenv("GGML_TPU_INT_DOT", value)
        assert config.int_dot() == on
    monkeypatch.setenv("GGML_TPU_INT_DOT", "1")
    assert torch.equal(mul_mat(q4, x[:1]),
                       mq.int_dot_matmul(q4, x[:1], plain=True))
    assert torch.equal(mul_mat(q4, x), mul_mat_q(q4, x))
    assert torch.equal(mul_mat(q4, x[:1], quantize_acts=False),
                       mul_mat_q(q4, x[:1], quantize_acts=False,
                                 mode=mm_dot_mode()))
    assert torch.equal(mul_mat(qk, x[:1]), mul_mat_q(qk, x[:1]))
    monkeypatch.delenv("GGML_TPU_INT_DOT")
    assert torch.equal(mul_mat(q4, x[:1]), mul_mat_q(q4, x[:1]))


def test_jax_int_dot_switch_is_inert_under_swar(monkeypatch):
    """The divergence ROADMAP.md §3 records: in the JAX package the SWAR
    kernel comes first, so GGML_TPU_INT_DOT=1 changes nothing there; the
    port has one layout and takes kernel B's route."""
    jw, tw = _pair("Q4_0")
    x = _x(1, seed=4)
    monkeypatch.setenv("GGML_TPU_INT_DOT", "1")
    sw = to_swar(jw)
    np.testing.assert_array_equal(
        np.asarray(jmq.mul_mat_q_fused(sw, jnp.asarray(x))),
        np.asarray(jmq.mul_mat_swar(sw, jnp.asarray(x))))
    assert torch.equal(mul_mat(tw, torch.from_numpy(x)),
                       mq.int_dot_matmul(tw, torch.from_numpy(x), plain=True))


def test_gates_drop_the_tile_clauses():
    """fused_supported / int_dot_supported keep the JAX gates' format and
    shape clauses and drop the TPU tile ones (here: N a multiple of 256)."""
    w = torch.from_numpy(_x(8, seed=2))  # [8, 512]
    for fmt in ("Q4_1", "Q6_K", "Q5_0"):
        qt = quantize(w, GType[fmt])
        jqt = jquantize(jnp.asarray(w.numpy()), JGType[fmt])
        assert mq.fused_supported(qt) and not jmq.fused_supported(jqt)
    q5 = quantize(w, GType.Q5_0)
    assert mq.int_dot_supported(q5, 1) and not mq.int_dot_supported(q5, 2)
    assert not mq.int_dot_supported(quantize(w, GType.Q4_K), 1)
    assert not mq.fused_supported(quantize(w, GType.Q8_K))
